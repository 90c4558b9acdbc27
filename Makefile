# Convenience targets (the reference ships a Makefile for docker workflows; here the
# targets map to the local dev loop).

.PHONY: test test-fast test-multiproc test-learning bench bench-suite train-smax

# Two pytest processes: the system-integration matrix runs in a FRESH
# interpreter. One ~40-min process compiling hundreds of XLA programs can
# segfault in the compilation-cache serializer near the end of the session
# (observed on the biggest graph, test_ff_masac_mahumanoid, which passes in
# isolation every time); process separation sidesteps the accumulated state.
test:
	python -m pytest tests/ -x -q --ignore=tests/test_systems_integration.py
	python -m pytest tests/test_systems_integration.py -x -q

test-fast:
	python -m pytest tests/ -x -q -k "not integration"

# Executed 2-process jax.distributed evidence: full loop (train + eval +
# logger gating + orbax multi-host checkpoint save/restore/continue) vs a
# single-process control. Not part of `make test` (spawns 3 jax processes —
# expensive on a one-core box and must not overlap other compiles).
test-multiproc:
	RUN_MULTIPROC_SMOKE=1 python -m pytest tests/test_multiproc_smoke.py -x -q -s

# Learning-threshold regression gate (opt-in: ~2-5 min of real training on the
# 8-device CPU mesh; catches semantic regressions — e.g. a flipped GAE sign —
# that still train and so pass the fast integration matrix).
test-learning:
	RUN_LEARNING_GATE=1 python -m pytest tests/test_learning_gate.py -x -q -s

bench:
	python bench.py

bench-suite:
	python scripts/bench_suite.py

train-smax:
	python -m mava_jax.systems.ppo.rec_ippo env=smax env/scenario=3s5z network=rnn \
	    arch.num_envs=64 system.recurrent_chunk_size=16
