"""The port's twins of the measurement scripts of `bench/` that launch a TPU
kernel: `ab_roofline` (K6, K7) and `bench_synthetic` (K8), with
`bench_common`. Run as modules: `python -m biped_pympc_tpu_torch.bench.<name>`."""
