"""Model registry (the surface of ``esmstereo_tpu/models/__init__.py``)
and the JAX weight bridge (``convert_jax``)."""

from __future__ import annotations


def build_model(name: str, config=None, device=None, seed: int = 0):
    """A registered model by name, on ``device`` (the card when None), its
    weights drawn from ``seed``; ``config`` None is the class default (L
    gwc; S gwc for the confidence model). ``ESMStereo_trt`` is an alias
    of ``ESMStereo``: the single-output path is eval mode (the reference
    needed a separate class for ONNX tracing,
    ``ESMStereo_trt.py:638,735``)."""
    if name in ("ESMStereo", "ESMStereo_trt"):
        from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,
                                                          ESMStereoConfig)
        return ESMStereo(config or ESMStereoConfig(), device=device,
                         seed=seed)
    if name == "ESMStereo_confidence":
        from esmstereo_tpu_torch.models.confidence import (
            CONFIDENCE_CONFIG, ESMStereoConfidence)
        return ESMStereoConfidence(config or CONFIDENCE_CONFIG,
                                   device=device, seed=seed)
    raise KeyError(f"unknown model {name!r}; have "
                   "ESMStereo, ESMStereo_trt, ESMStereo_confidence")


__models__ = {
    "ESMStereo": build_model,
    "ESMStereo_trt": build_model,
    "ESMStereo_confidence": build_model,
}
