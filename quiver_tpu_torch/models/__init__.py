"""quiver_tpu_torch.models."""
