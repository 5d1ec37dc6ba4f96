"""mola-sm-mm-convert: shuttle maps between .npz and MRPT-binary containers.

The reference toolchain consumes MRPT-serialized ``.simplemap`` / ``.mm``
files (mm-viewer, sm2mm, loop-closure postprocessing — the reason
``MOLA_SIMPLEMAP_ALSO_NON_KEYFRAMES`` exists, reference eval/cli_kitti.sh:
11-14).  This framework's runtime writes portable ``.npz`` containers
(utils/serialization.py); this converter bridges the two in both
directions so TPU runs feed the reference tools and reference artifacts
load here.

Port of ``mola_lidar_odometry_tpu/apps/convert.py``.  A local map is
loaded onto ``--device`` (the card unless ``cpu`` is given) and flattened
there; its points come to the host in one copy.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.convert IN OUT [--kind sm|mm] [--device cpu]

Direction and kind are inferred from the file names when unambiguous:
``*.npz`` input + ``*.simplemap``/``*.mm`` output exports to MRPT binary;
the reverse imports.  ``--kind`` disambiguates names carrying neither hint.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _infer_kind(a: str, b: str) -> str:
    s = a + " " + b
    if "simplemap" in s:
        return "sm"
    if ".mm" in s:
        return "mm"
    raise SystemExit("cannot infer --kind from file names; pass --kind sm|mm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--kind", choices=["sm", "mm"], default=None)
    ap.add_argument("--device", default="cuda", help="where a local map is flattened (cuda or cpu)")
    args = ap.parse_args(argv)

    from mola_lidar_odometry_tpu_torch.utils import serialization as S

    kind = args.kind or _infer_kind(args.input, args.output)
    to_mrpt = args.input.endswith(".npz") or args.output.endswith(
        (".simplemap", ".mm")
    )
    if kind == "sm":
        if to_mrpt:
            kfs = S.load_simplemap(args.input)
            S.export_simplemap_mrpt(args.output, kfs)
        else:
            kfs = S.import_simplemap_mrpt(args.input)
            S.save_simplemap(args.output, kfs)
        print(f"{len(kfs)} keyframes -> {args.output}")
    else:
        if to_mrpt:
            from mola_lidar_odometry_tpu_torch.models.odometry import resolve_device

            maps = S.load_metric_map(args.input, device=resolve_device(args.device))
            S.export_metric_map_mrpt(args.output, maps)
            print(f"{len(maps)} layers -> {args.output}")
        else:
            layers = S.import_metric_map_mrpt(args.input)
            # point layers re-import as plain arrays; persist via npz
            np.savez_compressed(
                args.output, **{f"layer_{k}": v for k, v in layers.items()}
            )
            print(f"{len(layers)} layers -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
