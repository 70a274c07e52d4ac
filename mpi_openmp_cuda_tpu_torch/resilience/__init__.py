"""Resilience runtime of the batch path: the retry policy (``policy``),
deterministic fault injection (``faults``), the backend degrade chain
(``degrade``), wall-clock deadlines (``watchdog``) and the preemption
drain (``drain``) — the ports of ``mpi_openmp_cuda_tpu/resilience/``'s
single-process modules.  Only stdlib and torch at import time."""
