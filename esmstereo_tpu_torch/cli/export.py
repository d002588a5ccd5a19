"""Export the stereo model for native serving.

The port's counterpart of ``tools/export_stablehlo.py`` (the reference's
ONNX exporter): the eval model at a fixed input shape as a
``torch.export`` program and an AOTInductor package
(``export.program``). Writes

  * ``<out>.pt2``: the AOTInductor package, which ``serving/stereo_infer``
    (C++, ``python3 -m esmstereo_tpu_torch.serving.build``) serves, and
    ``torch._inductor.aoti_load_package`` loads;
  * ``<out>.exported.pt2``: the ``ExportedProgram`` (``torch.export.save``),
    which ``torch.export.load`` reads again (in place of JAX's
    ``.jax_export.bin``).

    python -m esmstereo_tpu_torch.cli.export --loadckpt ckpt \\
        [--confidence --backbone mobilenetv2_100 --cv_scale 16 \\
         --cv norm_correlation] [--height 384 --width 1248] [--cpu]

It runs on the card unless ``--cpu`` is given, and raises without one. On
the CPU the package calls the operators' CPU kernels, which are Python:
it runs in a Python process only. The GELU form is the process's
(``nn.blocks.set_gelu_approximate``); the JAX CLI has no ``--fast_gelu``
either.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from esmstereo_tpu_torch.cli.common import (add_model_args,
                                            apply_runtime_flags,
                                            build_config)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="torch.export / AOTInductor "
                                            "exporter (PyTorch port)")
    add_model_args(p)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    p.add_argument("--loadckpt", default="",
                   help="a checkpoint of the port's training CLIs, or a "
                        "state_dict file (train.checkpoints.save_weights)")
    p.add_argument("--out", default="./StereoModel")
    p.add_argument("--confidence", action="store_true",
                   help="export the confidence variant (disp + confidence)")
    p.add_argument("--cpu", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from esmstereo_tpu_torch.export.program import (export_program, package,
                                                    specs)
    from esmstereo_tpu_torch.models import build_model
    from esmstereo_tpu_torch.train.checkpoints import load_weights

    if args.height % 32 or args.width % 32:
        raise ValueError("export shapes must be /32 multiples (the "
                         "reference pads to /32)")
    with apply_runtime_flags(args) as device:
        name = "ESMStereo_confidence" if args.confidence else "ESMStereo"
        model = build_model(name, build_config(args), device=device)
        if args.loadckpt:
            load_weights(args.loadckpt, model)
        t0 = time.perf_counter()
        ep = export_program(model, args.height, args.width, args.confidence)
        t1 = time.perf_counter()
        exported = args.out + ".exported.pt2"
        torch.export.save(ep, exported)
        t2 = time.perf_counter()
        pkg = package(ep, args.out + ".pt2")
        t3 = time.perf_counter()
    for path in (pkg, exported):
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    print(f"exported in {t1 - t0:.2f} s, saved in {t2 - t1:.2f} s, "
          f"AOTInductor compiled in {t3 - t2:.2f} s on {device}")
    inputs, outputs = specs(ep)
    print("input:", inputs, "-> output:", outputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
