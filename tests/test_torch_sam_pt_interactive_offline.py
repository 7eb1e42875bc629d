"""`SamPtInteractive` in offline mode (the ladder of IoU thresholds and
the fallback to the best pass), the port against the JAX package, with
the inputs, model pair and checks of test_torch_sam_pt_interactive.py."""
import torch

from test_torch_sam_pt_interactive import compare_with_jax, pair  # noqa: F401

torch.set_num_threads(1)


def test_interactive_offline_matches_jax(pair, tmp_path):  # noqa: F811
    compare_with_jax(pair, tmp_path, "offline")
