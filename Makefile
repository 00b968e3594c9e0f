# benlsip_tpu workflow targets (see CLAUDE.md for the full notes).

.PHONY: test gpu-smoke bench dryrun

# Full CPU suite (conftest forces CPU + x64 + 8 virtual devices).
test:
	python -m pytest tests/ -q

# On the GPU: the gpu-marked tests, then the main path at full size.
# Run whenever device-path code changed.
gpu-smoke:
	BENLSIP_GPU_TESTS=1 python -m pytest tests/ -m gpu -q
	python chip_smoke.py

# Headline bench (fails without a GPU).
bench:
	python bench.py

# Multi-chip dry run on a virtual 8-device CPU mesh.
dryrun:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun ok')"
