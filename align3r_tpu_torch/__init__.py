"""align3r_tpu_torch — the PyTorch + CUDA (Hopper) port of align3r_tpu.

The JAX package `align3r_tpu` stays the reference; every module here mirrors
its counterpart there (same file layout, same public functions) and is held
against it by the `tests/test_torch_*.py` parity tests.

- ``models``     — the Align3R two-view network as ``nn.Module``s whose
  parameter names are the reference checkpoint keys, plus the functional
  inference path that runs on prepared (stream-stacked, bf16) weights and
  the differentiable training forward (``Align3R.forward``); the two RAFT
  optical-flow networks (SEA-RAFT and classic RAFT) and their loaders.
- ``ops``        — hand-written Hopper kernels (``csrc/``), each beside its
  plain PyTorch version: the fused attention and MLP sites, the fused
  edge-residual loss (forward and backward) and the row permute that packs
  its observations, and attention for short sequences; the attention
  dispatch.
- ``geometry``   — camera geometry, pose parameterisations and
  depth-based warping.
- ``inference``  — the pairwise engine (unique-image encode, batched decode)
  and the frame and prior loaders.
- ``alignment``  — MST initialisation, the Adam global-alignment solve with
  its flow terms, the self-supervised motion masks and point-cloud cleaning.
- ``pipeline``   — ``reconstruct_scene`` (and its hierarchical form), the
  per-video entry point.
- ``eval``       — the scene writers (PLY, HTML viewer, .glb) and the
  trajectory formats and metrics; ``utils`` — PNG and Sintel files.
- ``compat``     — the dust3r-style API (``load_model``, ``make_pairs``,
  ``inference``, ``global_aligner``).
- ``training``   — losses, the train step and optimizer, the data loader
  and ``train``, the fine-tuning entry point.
- ``tools``      — the demo (``python -m align3r_tpu_torch.tools.demo``)
  and measurement scripts run on the card.

This package imports ``torch`` and never ``jax`` or ``align3r_tpu``.
"""

__version__ = "0.1.0"
