"""Process handles (the ``ProcessHandle`` of the JAX package's
``fleet/supervisor.py``; its ``FleetSupervisor`` and the rest of the
fleet tier are ROADMAP.md queue 1 item 23)."""

from __future__ import annotations


class ProcessHandle:
    """``multiprocessing.Process`` adapted to the Popen handle contract
    (``poll``/``terminate``/``kill``/``wait``), starting the process if
    it is not started yet."""

    def __init__(self, process):
        self._process = process
        if process.pid is None:
            process.start()

    @property
    def pid(self) -> int:
        return self._process.pid

    def poll(self) -> int | None:
        return self._process.exitcode

    def terminate(self) -> None:
        self._process.terminate()

    def kill(self) -> None:
        self._process.kill()

    def wait(self, timeout: float | None = None) -> int | None:
        self._process.join(timeout)
        return self._process.exitcode
