"""The port's probes: the four probe programs of ``benchmarks/`` (each with
a Pallas kernel, P1-P4) re-stated on the port's Hopper kernels. Each runs on
the card as ``python -m lemon_tpu_torch.benchmarks.<probe>``, raises without
one, and prints its results as JSON on its last line, as its JAX twin does.
``embed_modes`` times the ViT-B/32 embedding in each precision mode.
"""
