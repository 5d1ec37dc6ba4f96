"""Where a pass of kernel B3 (``csrc/align.cu``) spends its time, on one NVIDIA GPU.

    python3 -m mola_lidar_odometry_tpu_torch.ops.align_clock_split   # from the repo root

The kernel carries no instrumentation.  This module writes a scratch copy of
``csrc/align.cu`` with ``clock64()`` stamps inserted at fixed places of the
source (it stops if one is not found: the source changed), builds it with
``nvcc`` beside the port's own builds and runs it, through
:func:`pallas_icp.align_launcher`, on both align phases of ``chip_smoke.py``'s
phase 3 (B=8, npad=3072, C=16, the same seeded inputs).  It prints:

  * the device time per launch of the port's own build, arguments packed
    once, by CUDA events around CUDA-graph replays, at cluster sizes 8 and 16
    and at B=8 and 16 (the same instances twice), each run held against the
    plain twin (``chip_smoke.B3_TOL``);
  * the split of a Gauss-Newton pass on thread 0 of each instance's rank-0
    CTA: per-point work (match or moments), in-CTA reduction, cluster
    barrier (the prior's residual is computed inside it) and solve (the sum
    of the cluster's slots, the 6x6 solve and the pose broadcast), in cycles
    and in microseconds at the SM clock that ``nvidia-smi`` reads right
    after;
  * the latency floor of the serial chain: passes of the slowest instance x
    (barrier + solve).

Then one JSON line with the same numbers.  It exits non-zero without a CUDA
device.  The stamps add a few instructions per stage, so the instrumented
build runs a little slower than the port's.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

from mola_lidar_odometry_tpu_torch.ops import cuda_build, pallas_icp as pi

STAGES = ("pass", "reduce", "barrier", "solve")
SLOTS = 6  # the four stages, passes, cycles of the whole kernel
MAX_B = 64  # instances the scratch copy records

# (text of csrc/align.cu, the instrumented text that replaces it)
_PATCHES = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     f"__device__ long long g_align_clk[{MAX_B * SLOTS}];\n"),
    ("  extern __shared__ float4 smem_planes[];\n",
     "  const long long clk_start = clock64();\n"
     "  long long clk[5] = {0, 0, 0, 0, 0};\n"
     "  long long clk_mark = 0;\n"
     "  bool clk_on = false;\n"
     "  auto lap = [&](int k) {\n"
     "    const long long t = clock64();\n"
     "    if (clk_on) clk[k] += t - clk_mark;\n"
     "    clk_mark = t;\n"
     "  };\n"
     "  extern __shared__ float4 smem_planes[];\n"),
    ("    const float w = warp_reduce_transposed(v, lane);\n",
     "    lap(0);\n"
     "    const float w = warp_reduce_transposed(v, lane);\n"),
    ("    cluster_arrive();\n    if (warp == 0) tail();\n    cluster_wait();\n",
     "    lap(1);\n    cluster_arrive();\n    if (warp == 0) tail();\n    cluster_wait();\n    lap(2);\n"),
    ("    for (int g = 0; g < gn_inner; ++g) {\n",
     "    for (int g = 0; g < gn_inner; ++g) {\n"
     "      clk_on = true;\n"
     "      clk_mark = clock64();\n"),
    ("      cur = s_pose;\n",
     "      cur = s_pose;\n"
     "      lap(3);\n"
     "      clk[4] += 1;\n"),
    ("  // paired-ratio quality at the final pose\n",
     "  clk_on = false;\n"
     "  // paired-ratio quality at the final pose\n"),
    ("    o[15] = mom[19] / fmaxf(nvalid, 1.0f);\n",
     "    o[15] = mom[19] / fmaxf(nvalid, 1.0f);\n"
     f"    for (int k = 0; k < 5; ++k) g_align_clk[{SLOTS} * b + k] = clk[k];\n"
     f"    g_align_clk[{SLOTS} * b + 5] = clock64() - clk_start;\n"),
)
_READER = """
extern "C" int align_read_clocks(long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_align_clk, (size_t)n * sizeof(long long));
}
"""


def instrumented_source(src: str) -> str:
    """``csrc/align.cu`` with the clock64 stamps; each patched place must
    occur exactly once."""
    for old, new in _PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"align_clock_split: {old.strip()!r} occurs {src.count(old)} times in align.cu")
        src = src.replace(old, new)
    return src + _READER


def build_instrumented() -> ctypes.CDLL:
    out_dir = cuda_build._BUILD_ROOT / "align_clock_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "align_clock_split.cu"
    src.write_text(instrumented_source((cuda_build._CSRC / "align.cu").read_text()))
    lib = out_dir / "libalign_clock_split.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", *cuda_build._FLAGS["align"], "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def read_clocks(lib, B: int):
    import torch

    buf = (ctypes.c_longlong * (MAX_B * SLOTS))()
    cuda_build.check(lib.align_read_clocks(buf, MAX_B * SLOTS), "align_read_clocks")
    return torch.tensor(list(buf), dtype=torch.float64).view(MAX_B, SLOTS)[:B]


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return float(out.strip().splitlines()[0])


def geometry(npad: int, C: int, cluster: int) -> pi.AlignGeometry:
    """One point per thread at ``cluster`` CTAs per instance, planes in shared memory."""
    sl = npad // cluster
    if sl * cluster != npad or sl % 4 or sl > pi.MAX_THREADS or 16 * C * sl > pi.SMEM_PLANES_MAX:
        raise ValueError(f"align_clock_split: no one-point geometry at cluster {cluster}")
    return pi.AlignGeometry(cluster, sl, -(-sl // 32) * 32, 1, 16 * C * sl, True)


def main():
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("align_clock_split: no CUDA device visible")
    dev = "cuda"
    m, local, valid = chip_smoke.kernel_inputs(dev)
    c = chip_smoke.align_case(dev, m, local, valid)
    calls = [(c["args3a"], c["kw3a"], c["ref3a"]), (c["args3b"], c["kw3b"], c["ref3b"])]
    C, npad = c["args3a"][0][0].shape[1:]
    B = valid.shape[0]
    lib_clk = build_instrumented()
    lib_clk.align_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib_clk.align_read_clocks.restype = ctypes.c_int
    card = chip_smoke.card_line()
    chip_smoke.log(f"align_clock_split: {card}; B={B}, npad={npad}, C={C}")

    def dup(x):
        if torch.is_tensor(x):
            return torch.cat([x, x]).contiguous()
        return tuple(dup(y) for y in x) if isinstance(x, tuple) else x

    calls16 = [(dup(a), {k: dup(v) for k, v in kw.items()}, dup(ref)) for a, kw, ref in calls]
    results = []
    for cluster in (8, 16):
        geo = geometry(npad, C, cluster)
        if cluster == pi.CLUSTER and tuple(geo) != tuple(pi.align_geometry(npad, C)):
            raise AssertionError(f"align_clock_split: {geo} is not the port's {pi.align_geometry(npad, C)}")
        for cs in (calls, calls16):
            runs = [pi.align_launcher(geo, *a, **kw) for a, kw, _ in cs]
            for (_, _, ref), (launch, result) in zip(cs, runs):
                launch()
                chip_smoke.check_align(f"B3 at cluster {cluster}, B={len(ref[0])}", result(), ref)
            ms = chip_smoke.cuda_graph_ms(lambda: [launch() for launch, _ in runs], 20) / 2
            results.append(dict(cluster=cluster, B=len(cs[0][2][0]), ms_per_launch=ms))
            chip_smoke.log(f"align_clock_split: cluster {cluster}, B={len(cs[0][2][0])} ({geo.threads} threads, "
                           f"{geo.smem_bytes} B shared): {ms:.4f} ms per launch")

    geo = pi.align_geometry(npad, C)
    clocks = []
    with mock.patch.object(cuda_build, "load", lambda name: lib_clk):
        runs = [pi.align_launcher(geo, *a, **kw) for a, kw, _ in calls]
    for (_, _, ref), (launch, result) in zip(calls, runs):
        launch()
        chip_smoke.check_align(f"B3 instrumented at cluster {geo.cluster}", result(), ref)
        torch.cuda.synchronize()
        clocks.append(read_clocks(lib_clk, B))
    mhz = sm_clock_mhz()
    ck = torch.stack(clocks)  # (phase, B, slot)
    passes = ck[..., 4].sum()
    cyc = {s: float(ck[..., k].sum() / passes) for k, s in enumerate(STAGES)}
    us = {s: v / mhz for s, v in cyc.items()}
    slowest = float(ck[..., 4].max(dim=1).values.sum()) / 2  # passes of the slowest instance per launch
    floor_ms = slowest * (us["barrier"] + us["solve"]) / 1e3
    split = ", ".join(f"{s} {us[s]:.3f} us ({100 * cyc[s] / sum(cyc.values()):.1f}%)" for s in STAGES)
    chip_smoke.log(f"align_clock_split: cluster {geo.cluster}, per pass {split}; SM clock {mhz:.0f} MHz; "
                   f"{slowest:.1f} passes of the slowest instance per launch, chain floor (barrier + solve) "
                   f"{floor_ms:.4f} ms per launch; instrumented kernel "
                   f"{float(ck[..., 5].max(dim=1).values.mean()) / mhz / 1e3:.4f} ms per launch by clock64")
    results.append(dict(cluster=geo.cluster, B=B, cycles_per_pass=cyc, us_per_pass=us, sm_mhz=mhz,
                        passes_slowest_per_launch=slowest, chain_floor_ms_per_launch=floor_ms))
    print(json.dumps({"align_clock_split": results, "card": card}), flush=True)


if __name__ == "__main__":
    main()
