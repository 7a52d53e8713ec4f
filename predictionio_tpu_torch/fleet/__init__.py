"""The fleet tier's process discipline. Only ``supervisor.ProcessHandle``
is ported, for the parallel evaluation grid (``experiment/grid.py``);
the router, membership, supervisor, scale controller, gateway, canary,
transport and worker pool are ROADMAP.md queue 1 item 23."""
