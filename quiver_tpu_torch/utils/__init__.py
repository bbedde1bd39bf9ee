"""quiver_tpu_torch.utils."""
