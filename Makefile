# TPU-native analogue of the reference build/deploy makefile (makefile:1-15).
#
# Reference targets -> TPU equivalents:
#   build   mpicxx+nvcc link          ->  g++ driver + embedded-CPython backend
#   run     mpiexec -np 2 ./final     ->  ./final (backend shards via
#                                         TPU_SEQALIGN_MESH instead of ranks)
#   runOn2  mpiexec 2 machines        ->  multi-host JAX (python -m ... --distributed)
#   clean                             ->  clean
#
# The Python package itself needs no build step; `final` is the native
# host-driver path (SURVEY §7.3 step 6).

PYTHON     ?= python3
PYCONFIG   ?= $(PYTHON)-config
CXX        ?= g++
CXXFLAGS   ?= -O2 -std=c++17 -Wall -Wextra
PY_CFLAGS  := $(shell $(PYCONFIG) --includes)
PY_LDFLAGS := $(shell $(PYCONFIG) --ldflags --embed)
INPUT      ?= /root/reference/input5.txt

.PHONY: build run run2 runOn2 test chaos chaos-kill analyze schedule-audit concurrency-audit donation-audit comms-audit ranges-audit exitpath-audit metrics-smoke serve-smoke serve-chaos fleet-chaos fleet-trace-smoke load-smoke aot-smoke trace-smoke bench bench-table bench-gather check clean

build: final

final: native/main.cpp native/tpu_backend.cpp native/tpu_proto.h
	$(CXX) $(CXXFLAGS) -DTPU_SEQALIGN_REPO_ROOT='"$(CURDIR)"' \
	    native/main.cpp native/tpu_backend.cpp -o $@ \
	    $(PY_CFLAGS) $(PY_LDFLAGS) -lpthread

# The port's native driver: the same driver and ABI over the PyTorch +
# CUDA package (mpi_openmp_cuda_tpu_torch/native/torch_backend.cpp); env
# knobs TPU_SEQALIGN_BACKEND (auto|cuda|mm|gather|oracle), TPU_SEQALIGN_MESH,
# TPU_SEQALIGN_DEVICE (cuda|cpu) and TPU_SEQALIGN_PYROOT.
TORCH_BACKEND := mpi_openmp_cuda_tpu_torch/native/torch_backend.cpp

final_torch: native/main.cpp $(TORCH_BACKEND) native/tpu_proto.h
	$(CXX) $(CXXFLAGS) -DTPU_SEQALIGN_REPO_ROOT='"$(CURDIR)"' -I native \
	    native/main.cpp $(TORCH_BACKEND) -o $@ \
	    $(PY_CFLAGS) $(PY_LDFLAGS) -lpthread

# Single host; all local devices. The reference's `run` is 2 ranks on one
# node (makefile:11) — the mesh analogue is run2.
run: final
	./final < $(INPUT)

# TPU_SEQALIGN_MESH takes the full --mesh grammar: N / batch:N (data
# parallel), seq:N (Seq1 ring-sharded), DxS (2-D dp x sp).
run2: final
	TPU_SEQALIGN_MESH=2 ./final < $(INPUT)

runRing: final
	TPU_SEQALIGN_MESH=seq:2 ./final < $(INPUT)

# Two-machine deployment (reference runOn2, makefile:15): every host runs
# the same command; host 0 reads stdin.  Requires JAX_COORDINATOR_ADDRESS,
# JAX_NUM_PROCESSES, JAX_PROCESS_ID in the environment (the machinefile's
# replacement; parallel/distributed.py).
runOn2:
	$(PYTHON) -m mpi_openmp_cuda_tpu --distributed < $(INPUT)

# Fast default gate: slow-marked tests (multi-process, cap-scale ring)
# need --runslow and run via `make check` / `make test-all` (VERDICT r2
# item 7).
#
# TIER BUDGETS (r5, measured compile-cold on the quiet 1-core box —
# re-measure after adding any interpret-compiling test; every extra
# compiled shape bucket costs ~10-20 s here):
#   default tier  budget < 300 s with >= 10% headroom; measured 238-249 s
#                 (2026-07-31 r5; r4 had drifted to 303 s — reclaimed by
#                 sharing compiled shape buckets across tests, see
#                 test_ring/_pallas_scorer r5 comments)
#   slow tier     budget ~12 min; measured 11:21 (2026-07-31 r5;
#                 r4's 15:35 was 22% one cap-scale ring test, shrunk to
#                 the same hop count at 4x instead of 8x the cap)
# Timings are meaningless if ANYTHING else runs on the box (a 103 s
# suite has read 439 s under concurrent load).
test:
	$(PYTHON) -m pytest tests/ -q

# Chaos tier: the fast suite under an ambient deterministic fault spec
# (resilience/faults.py).  Every CLI run absorbs two transient
# chunk-scoring faults, one journal-append fault, AND one injected
# dispatch hang (classified by the ambient SEQALIGN_DEADLINE_S watchdog)
# inside the SEQALIGN_FAULT_RETRIES floor, so the goldens must stay
# byte-identical; tests that assert exact attempt counts or fail-stop
# exit codes carry the no_chaos marker and are skipped (conftest).  The
# retry floor is 4: worst case one run absorbs the hang (1) plus both
# chunk_scoring faults (2) on the same shared budget.  The near-zero
# backoff base keeps the injected retries from inflating the tier wall.
chaos:
	JAX_PLATFORMS=cpu \
	SEQALIGN_FAULTS="chunk_scoring:fail=2;journal_append:fail=1;hang:dispatch:fail=1" \
	SEQALIGN_FAULT_RETRIES=4 SEQALIGN_BACKOFF_BASE=0.01 \
	SEQALIGN_DEADLINE_S=0.05 \
	$(PYTHON) -m pytest tests/ -q

# Kill-resume chaos tier: subprocess tests that SIGKILL a run mid-batch
# at a scheduled journal append (kill:journal-append) and assert the
# rerun with --resume is byte-identical (tests/test_survival.py; slow +
# chaos_kill marked, so neither the default tier nor `make chaos` pays
# the subprocess fan-out).
chaos-kill:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -q --runslow -m chaos_kill

# Static-analysis gate (docs/ARCHITECTURE.md §9): seqlint, the
# exhaustive VMEM chooser sweep, the eval_shape entry-point contract
# audit, plus ruff/mypy when installed (gated on availability — the
# deployment container does not ship them).  CPU-only, a few seconds.
analyze:
	$(PYTHON) scripts/analyze.py

# Trace-level schedule gate (docs/ARCHITECTURE.md §9): price the
# deterministic input3-class schedule with the static cost model, lower
# every entry point + bucket body on CPU, audit donation/transfers/
# launch structure, and diff the stable fields against the committed
# golden (tests/golden/schedule_audit.json; regenerate deliberately
# with scripts/schedule_audit.py --update).  CPU-only, zero devices.
schedule-audit:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/schedule_audit.py

# Concurrency gate (docs/ARCHITECTURE.md §9): the whole-program
# lock-graph audit (ordering cycles, blocking ops under serve/obs
# locks, cross-class acquire/release) plus the exhaustive interleaving
# explorer running the REAL fleet-protocol state machines to a depth
# bound, diffed against the committed golden
# (tests/golden/concurrency_audit.json; regenerate deliberately with
# scripts/concurrency_audit.py --update).  CPU-only, a few seconds.
concurrency-audit:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/concurrency_audit.py

# Donation-safety gate (docs/ARCHITECTURE.md §9): the whole-program
# dataflow pass proving which jit-entry operands are dead at every
# call site (incl. the retry/degrade/rescue re-dispatch ladders), then
# the trace-audit enforcement that every provably-dead large buffer is
# donated and every pinned-live one carries a reason, diffed against
# the committed golden (tests/golden/donation_plan.json; regenerate
# deliberately with scripts/donation_audit.py --update).  CPU-only.
donation-audit:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/donation_audit.py

# Collective-safety gate (docs/ARCHITECTURE.md §9): lower every
# parallel/specs.py mesh form on the forced 8-virtual-device CPU
# backend, inventory every collective (op, axes, payload bytes), prove
# per-position ordering consistency (replica-divergent sequences fail
# closed), gate resharding hygiene against the post-partitioning HLO,
# cross-check the ring against ring_plan's R, and diff the inventory +
# modelled ICI comms/scaling rows against the committed golden
# (tests/golden/comms_audit.json; regenerate deliberately with
# scripts/comms_audit.py --update).  CPU-only, zero real devices.
comms-audit:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/comms_audit.py

# Numeric-exactness gate (docs/ARCHITECTURE.md §9): abstract
# interpretation in an interval domain over every scoring jaxpr —
# re-derive every hand numeric bound (max_exact_value, the 2^19
# rowpack gate, the 2^31 argmax packing, the feed ceilings) and diff
# each against its wired source, certify every entry contract and
# every production-bucket body exact at its envelope, map the signed
# int16 envelope (the BLOSUM/PAM prerequisite), and diff the cert
# against the committed golden (tests/golden/ranges_cert.json;
# regenerate deliberately with scripts/ranges_audit.py --update).
# CPU-only, zero devices, a few seconds.
ranges-audit:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/ranges_audit.py

# Failure-path gate (docs/ARCHITECTURE.md §9): whole-program
# exception-flow analysis over the raise/except/finally propagation
# graph — prove every production raise reaches exactly one legal sink
# (RetryPolicy taxonomy / typed wire reply / sysexits map / reasoned
# `# advisory:` swallow), every cli/serve exit path passes the
# finally-first flush, exit 75 is deadline/drain-rooted only, every
# fault-registry site still fires, and diff the sink inventory against
# the committed golden (tests/golden/exitpath_audit.json; regenerate
# deliberately with scripts/exitpath_audit.py --update).  Pure AST
# walking — no devices, under a second.
exitpath-audit:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/exitpath_audit.py

# Observability smoke gate (docs/ARCHITECTURE.md §10): one CLI run on
# the tiny fixture with --metrics --metrics-out, then schema-validate
# the JSON run report and its Prometheus sidecar.  CPU-only, seconds.
metrics-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/metrics_smoke.py

# Serving-plane smoke gate (docs/ARCHITECTURE.md §12): boot --serve
# --port 0 as a subprocess, run 6 concurrent loopback clients sharing
# one problem key, SIGTERM, then gate coalescing (dispatches < requests),
# steady-state recompiles == 0, drain exit 75, and the run report
# schema.  CPU-only, seconds.
serve-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/serve_smoke.py

# Serve chaos tier (docs/ARCHITECTURE.md §12, SLO armor): deterministic
# pipe-mode --serve subprocesses under counted fault schedules — breaker
# open→half-open→close, poison-superblock bisection, overload shedding
# with typed retry hints, mid-stream client loss, the byte-identical
# drained-journal golden, and the unknown-fault-site exit-64 gate.
# CPU-only, seconds.
serve-chaos:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/serve_chaos.py

# Open-loop load tier (docs/ARCHITECTURE.md §12.10): boot --serve, run
# the traffic factory through calibrate -> 2x -> 5x saturation phases
# (constant/burst arrival processes, deadline mix, captured schedule),
# gate answered-or-typed survival + goodput retention + the serve-load
# bench record schema, then close the loop: refit the admission cost
# scale and budget from the trace's measured launch walls and replay
# the IDENTICAL captured schedule under the refit knobs, gating the
# p99 queue-wait improvement.  CPU-only, a couple of minutes.
load-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/load_smoke.py

# Fleet chaos tier (docs/ARCHITECTURE.md §8.6): a real coordinator
# (--serve --fleet-board) plus real --fleet-worker subprocesses over a
# shared FileBoard, under counted fault schedules — kill -9 mid-
# superblock with dead-worker re-dispatch to a survivor, a zombie's
# stale post fenced by epoch, a torn half-written result read as
# missing, a stalled lease reclaimed — every scenario gated on per-id
# records byte-identical to a clean fleetless run (exactly once, no
# loss, no doubles).  CPU-only, under a minute.
fleet-chaos:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/fleet_chaos.py

# Fleet observability smoke gate (docs/ARCHITECTURE.md §10): a real
# coordinator (--serve --port 0 --telemetry-port 0 --fleet-board) plus
# two --fleet-worker subprocesses, one SIGKILLed mid-run — gate trace-id
# propagation onto worker launches, the five-phase board attribution
# (totals == sums), worker-labelled /metrics federation for both
# workers, the dead worker's collected flight-recorder tape, and the
# merged per-worker Perfetto tracks.  CPU-only, seconds.
fleet-trace-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/fleet_trace_smoke.py

# Tracing-tier smoke gate (docs/ARCHITECTURE.md §10): boot --serve
# --port 0 --telemetry-port 0 --trace-out, run 2 coalescing clients,
# scrape the LIVE registry (HTTP /metrics + in-band {"cmd": ...} verbs)
# mid-run and gate it against the exit-time run report, validate the
# kind="trace" artifact (every launch linked to requests, finite gap
# rows), then gate the watchdog-expiry flight-recorder dump from an
# injected dispatch hang.  CPU-only, seconds.
trace-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/trace_smoke.py

# AOT warm-plane smoke gate (docs/ARCHITECTURE.md §13): cross-check the
# warm set against the committed hot-config ranking, populate a
# throwaway cache with a real --prewarm batch subprocess (gate the
# manifest), then RESTART into --serve --prewarm and hard-gate
# steady_compiles == 0 from tick 0 — the restarted process answers its
# first request with zero backend compiles.  CPU-only, seconds.
aot-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/prewarm_smoke.py

# Full coverage in TWO pytest processes: the fast tier, then the
# slow-marked tests alone.  A single combined process segfaults jaxlib's
# XLA:CPU compiler reproducibly (3/3 runs, same test, with and without
# the persistent compile cache) once ~190 tests of program churn precede
# one particular interpret-mode compile; each tier alone passes every
# time.  The union of the two selections is exactly `--runslow` in one
# process — tests are independent, nothing is lost by the split.
test-all:
	$(PYTHON) -m pytest tests/ -q
	$(PYTHON) -m pytest tests/ -q --runslow -m slow

# Everything a round-end check runs: FULL suite (slow tier included),
# driver hooks, native goldens.  `final` is an ordered prerequisite of
# `test-all` here: the suite's native tests rebuild it via a nested make,
# which must not race this one.
check: final
	$(MAKE) test-all
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	    DRYRUN_DEVICES=8 $(PYTHON) __graft_entry__.py
	JAX_PLATFORMS=cpu ./final < tests/fixtures/tiny.txt > /tmp/check_tiny.out
	diff /tmp/check_tiny.out tests/fixtures/tiny.out

# Hardware conformance: every backend x MXU-feed regime vs the oracle on
# the REAL device (interpret-mode tests cannot see Mosaic/MXU-precision
# divergences).  Run after any kernel or numerics change.
check-tpu:
	$(PYTHON) scripts/tpu_conformance.py

bench:
	$(PYTHON) bench.py

# The full BASELINE.md config table (input2/3/5 + max-size synthetic).
bench-table:
	$(PYTHON) scripts/bench_table.py

# The >=4096-weight regime's official-protocol row.  40000 > 32767 (the
# length-aware f32 ceiling at l2p=128), so every bucket routes to the
# int32 gather fallback — the record's "formulation" field must read
# "xla-gather"; weights <= 32767 would be rescued into the exact f32
# kernel on short-Seq2 buckets and silently time the wrong regime.
bench-gather:
	BENCH_BACKEND=pallas BENCH_WEIGHTS=40000,7,1,2 $(PYTHON) bench.py

clean:
	rm -f final final_torch
