"""The warm plane: a warm-set manifest and the startup prewarm (the port
of ``mpi_openmp_cuda_tpu/aot/``).

The JAX package warms because XLA and Mosaic compile every program anew
in each process.  The port compiles no program per shape; a first launch
on the card pays other cold costs instead:

* the ``nvcc`` build of a kernel's library, cached on disk under
  ``build/torch_kernels/`` and keyed by a hash of its sources and flags
  (``ops/_build.py``), and its ``ctypes`` load;
* the fused kernel's shared-memory opt-in the first time a width needs
  more than 48 KB (``ops/cuda_scorer.py::check_smem``);
* CUDA's lazy load of each kernel function's module at its first launch;
* the caching allocator's first blocks and the pinned staging buffers of
  ``ops/dispatch.py``.

``ops/_build.py::build_count`` counts the first three kinds (builds, loads
and opt-ins); the serve loop's ``serve_steady_compiles`` gauge is its
delta.  "Warm" is a process whose next launch at a warmed shape pays none
of the four.

Four modules, one contract:

* :mod:`.warmset`: WHAT to warm, one :class:`~.warmset.WarmEntry` a launch
  shape as the port dispatches it (the problem's launches and the serve
  superblock shapes), and the fingerprint (torch, CUDA, the card, nvcc
  flags, kernel sources) that scopes an entry's validity;
* :mod:`.compile`: HOW, one entry at a time: load the kernels, opt in the
  width, one launch at the entry's shape through ``dispatch.run_launch``;
* :mod:`.manifest`: the atomic, versioned manifest of what was warmed,
  under ``<cache home>/aot/<platform tag>.json``, with staleness by
  fingerprint digest;
* :mod:`.prewarm`: the process-start orchestration behind ``--prewarm``
  / ``SEQALIGN_PREWARM``.
"""

from __future__ import annotations
