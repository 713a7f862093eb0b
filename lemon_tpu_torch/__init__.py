"""lemon_tpu_torch: LEMoN label-error detection in PyTorch and CUDA.

The PyTorch port of :mod:`lemon_tpu`, module for module. The JAX package
stays the reference; each module here names the counterpart it mirrors.

- ``lemon_tpu_torch.core``    — device selection, the process mesh, run-output contract, phase timing
- ``lemon_tpu_torch.data``    — dataset registry, label/caption noise, splits
- ``lemon_tpu_torch.ops``     — image preprocessing and the CUDA kernels (K1-K4, P1-P4)
- ``lemon_tpu_torch.models``  — CLIP towers, weight loaders, batched encoder
- ``lemon_tpu_torch.knn``     — exact nearest-neighbour index (one device, sharded, host C++)
- ``lemon_tpu_torch.scoring`` — LEMoN score, hyperparameter fit, metrics
- ``lemon_tpu_torch.train``   — contrastive CLIP training, preemption snapshots, filtering
- ``lemon_tpu_torch.baselines`` — the detection baselines
- ``lemon_tpu_torch.cli``     — ``run_lemon``, ``run_baseline`` and ``train_clip`` entry points
- ``lemon_tpu_torch.benchmarks`` — the probe programs of P1-P4, on the card

The package imports ``torch`` and never ``jax``, ``flax``, ``optax`` or ``orbax``.
"""

__version__ = "0.1.0"
