"""What bounds kernel B2 (``reselect_kernel``, ``csrc/capture.cu``), on one NVIDIA GPU.

    python3 -m mola_lidar_odometry_tpu_torch.ops.reselect_probe   # from the repo root

This module writes scratch copies of ``csrc/capture.cu``, each with one
change at a fixed place of the source (it stops if the place is not found:
the source changed), builds them with ``nvcc`` beside the port's own builds
(``-Xptxas -v`` for their registers), and times B1 and B2 alone, arguments
packed once, by CUDA events around CUDA-graph replays, at the inputs of
``chip_smoke.py``'s phase 3 (B=8, P=8, npad=3072, K=20, stride 32), each
launch held bit for bit against the plain twins.  The builds run in turns,
the port's first and last, so that drift shows.  Copies:

  * ``two_scans``: the top-2 as two first-min scans over a K-wide distance
    array (the selection B2 was first redesigned with), against the port's
    one-pass top-2;
  * ``sector64``: B2's header pass also reads each way's second 32-byte
    sector, so the working set (about 50 MB at these inputs) no longer fits
    in the L2 and the replays read it from DRAM.

Then one JSON line with the same numbers.  It exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

from mola_lidar_odometry_tpu_torch.ops import cuda_build, pallas_capture as pc

_ONE_PASS = """  float d1 = kBig, d2 = kBig;
  int w1 = words[2], w2 = words[2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (4 * c < 2 + nk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * c + j - 2;
        if (k >= 0 && k < nk) {
          float xs[3];
          const float d = dequant(words[4 * c + j], e, vs, ql, xs);
          if (d < d1) { d2 = d1; w2 = w1; d1 = d; w1 = words[4 * c + j]; }
          else if (d < d2) { d2 = d; w2 = words[4 * c + j]; }
        }
      }
    }
  }
"""
_TWO_SCANS = """  float dk[kMaxK];
  float xs[3];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) dk[k] = (k < nk) ? dequant(words[2 + k], e, vs, ql, xs) : kBig;
  float d1 = dk[0];
  int w1 = words[2], k1 = 0;
#pragma unroll
  for (int k = 1; k < kMaxK; ++k)
    if (k < nk && dk[k] < d1) { d1 = dk[k]; k1 = k; w1 = words[2 + k]; }
  float d2 = (k1 == 0) ? kBig : dk[0];
  int w2 = words[2];
#pragma unroll
  for (int k = 1; k < kMaxK; ++k) {
    const float d = (k == k1) ? kBig : dk[k];
    if (k < nk && d < d2) { d2 = d; w2 = words[2 + k]; }
  }
"""
_HEADERS = "  for (int w = 0; w < W; ++w) { h0[w] = __ldg(row + w * kWay); h1[w] = __ldg(row + w * kWay + 1); }\n"
_SECTOR64 = _HEADERS + """  unsigned spare = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int4 a = __ldg(row + w * kWay + 2), c = __ldg(row + w * kWay + 3);
    spare ^= (unsigned)(a.x ^ a.y ^ a.z ^ a.w ^ c.x ^ c.y ^ c.z ^ c.w);
  }
"""
_B2_MASK = "  select_top2(words, nk, e, vs, ql, (has_valid && !vq) ? 0.f : 1.f, cx, cy, cz, cm, o1, o1 + (size_t)P * npad);\n}\n\n}"
# the words read are kept live by a mask test that no real input meets
_B2_MASK_SPARE = _B2_MASK.replace("(has_valid && !vq)", "((has_valid && !vq) || spare == 0x9E3779B9u)")

# copy name -> (text of csrc/capture.cu, the text that replaces it)
PATCHES = {
    "two_scans": ((_ONE_PASS, _TWO_SCANS),),
    "sector64": ((_HEADERS, _SECTOR64), (_B2_MASK, _B2_MASK_SPARE)),
}


def patched_source(src: str, name: str) -> str:
    """``csrc/capture.cu`` with copy ``name``'s change; each patched place
    must occur exactly once."""
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"reselect_probe: {old.strip()[:60]!r} occurs {src.count(old)} times in capture.cu")
        src = src.replace(old, new)
    return src


def build_copies():
    """Build every copy at once; returns {name: (library, ptxas report)}."""
    out_dir = cuda_build._BUILD_ROOT / "reselect_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_build._CSRC / "capture.cu").read_text()
    procs = {}
    for name in PATCHES:
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(patched_source(src, name))
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", *cuda_build._FLAGS["capture"], "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"reselect_probe: nvcc failed for {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), log)
    return built


def main():
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("reselect_probe: no CUDA device visible")
    dev = "cuda"
    chip_smoke.phase_build()
    built = build_copies()
    m, local, valid = chip_smoke.kernel_inputs(dev)
    c = chip_smoke.align_case(dev, m, local, valid)
    card = chip_smoke.card_line()
    libs = {"port": cuda_build.load("capture"), **{k: lib for k, (lib, _) in built.items()}}
    reports = {"port": cuda_build.build_log.get("capture", ""), **{k: log for k, (_, log) in built.items()}}
    chip_smoke.log(f"reselect_probe: {card}; phase-3 inputs, B2's sectors fit in the L2 unless read as 64 bytes")
    order = list(libs) + list(libs)[::-1]
    results = {k: dict(B1_ms=[], B2_ms=[]) for k in libs}
    for name in order:
        with mock.patch.object(cuda_build, "load", lambda _name, lib=libs[name]: lib):
            (launch1, result1), (launch2, result2) = (pc.capture_launcher(*c["args1"], **c["kw1"]),
                                                      pc.reselect_launcher(*c["args2"], **c["kw2"]))
        launch1()
        launch2()
        torch.cuda.synchronize()
        if not (all(torch.equal(g, r) for g, r in zip(result1(), c["ref1"]))
                and all(torch.equal(g, r) for g, r in zip(result2(), c["ref2"]))):
            raise AssertionError(f"reselect_probe: {name} differs from the plain twins")
        results[name]["B1_ms"].append(chip_smoke.cuda_graph_ms(launch1, 20))
        results[name]["B2_ms"].append(chip_smoke.cuda_graph_ms(launch2, 20))
        chip_smoke.log(f"reselect_probe: {name}: bit-exact; B1 {results[name]['B1_ms'][-1]:.4f} ms, "
                       f"B2 {results[name]['B2_ms'][-1]:.4f} ms alone")
    with mock.patch.dict(cuda_build.build_log, {"capture": ""}):
        for name, report in reports.items():
            cuda_build.build_log["capture"] = report
            results[name]["registers"] = "; ".join(
                chip_smoke.ptxas_report("capture", k) for k in ("capture_gather_kernel", "reselect_kernel"))
            chip_smoke.log(f"reselect_probe: {name}: {results[name]['registers']}")
    print(json.dumps({"reselect_probe": results, "card": card}), flush=True)


if __name__ == "__main__":
    main()
