"""ESMStereo-L and the JAX weight bridge."""
