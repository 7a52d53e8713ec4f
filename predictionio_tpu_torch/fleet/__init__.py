"""The fleet tier's process discipline: the supervisor
(``supervisor.py``: ``ProcessHandle`` for the parallel evaluation grid,
``FleetSupervisor`` for ``pio deploy --workers N --supervise``), the
worker pool's peering (``workers.WorkerHub``) and its loopback client
(``transport.py``). The router, membership, scale controller, gateway
and canary are ROADMAP.md queue 1 item 23."""
