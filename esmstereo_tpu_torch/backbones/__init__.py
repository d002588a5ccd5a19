"""Feature pyramid backbones and the fused backbone head."""
