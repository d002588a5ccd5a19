"""Learning-rate schedule: the reference's ``lrepochs`` string.

Counterpart of ``esmstereo_tpu/train/schedule.py`` (the reference's
``utils/experiment.py:103-125``): ``"20,32,40,48,56:2"`` divides the base
LR by 2 at each listed epoch, cumulatively.
"""

from __future__ import annotations

from typing import Callable


def parse_lrepochs(spec: str) -> tuple[list[int], float]:
    head, rate = spec.split(":")
    return [int(e) for e in head.split(",")], float(rate)


def lr_for_epoch(base_lr: float, epoch: int, spec: str) -> float:
    """The LR of ``epoch`` (the reference's loop exactly)."""
    epochs, rate = parse_lrepochs(spec)
    lr = base_lr
    for eid in epochs:
        if epoch >= eid:
            lr /= rate
        else:
            break
    return lr


def lr_schedule_fn(base_lr: float, spec: str, steps_per_epoch: int
                   ) -> Callable[[int], float]:
    """step -> LR, as the JAX package's optax schedule: the step counts
    the updates made before it (optax's ``count``, so step 0 takes
    ``lr_fn(0)``), and its epoch is ``step // steps_per_epoch``. The
    divisions count every listed epoch reached, as the JAX function sums
    them."""
    epochs, rate = parse_lrepochs(spec)

    def fn(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr / rate ** sum(epoch >= e for e in epochs)

    return fn
