"""quiver_tpu_torch.feature."""
