"""quiver_tpu_torch.serving."""
