"""The readings a cell's correctness limits are set from, on the card.

    python3 port_bench/readings.py --workload <cell> --seeds 11,12,13 [--control]

For each seed, in one process: make the cell's scans, step the fleet over
one episode from a fresh carry (the window's step and read-back), run the
plain reference over the sampled instances, and print the compared numbers
of the program (``program``).  With ``--control``, also put the control in
the program's place (the reference with its ICP given no iterations,
breaking the registration the configuration states) over the same instances and
print its numbers against the reference (``control``); its
``fleet_gt_worst_m`` covers the sampled instances only.  One JSON line per
seed and side.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_rows(seqs: list):
    """The control's outputs, one sequence per instance, laid out as the
    program's read-back rows ``(frames, instances, columns)``."""
    import numpy as np

    from port_bench.harness.program import COLUMNS, FIELDS

    rows = np.zeros((len(seqs[0]), len(seqs), sum(w for _, w in FIELDS)), np.float32)
    for i, seq in enumerate(seqs):
        for k, o in enumerate(seq):
            r = rows[k, i]
            r[COLUMNS["R"]] = o.R.reshape(-1)
            r[COLUMNS["t"]] = o.t
            r[COLUMNS["quality"]] = o.quality
            r[COLUMNS["iterations"]] = o.iterations
            r[COLUMNS["kf_local"]] = o.kf_local
            r[COLUMNS["accepted"]] = o.accepted
            r[COLUMNS["n_icp_layer"]] = o.n_icp_layer
            r[COLUMNS["n_map_layer"]] = o.n_map_layer
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from port_bench.harness import check, program

    cell = program.load_cell(args.workload)
    yaml_path = str(program.BENCH / cell.config["pipeline"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = program.build(cell, seed, "cuda", log=lambda *a: print(*a, file=sys.stderr, flush=True))
        carry = program.fresh_carry(prog)
        rows = []
        for k in range(prog.frames):
            carry, out = prog.step(carry, prog.scans[k])
            rows.append(program.readback(out))
        episode = np.stack(rows)
        sample = check.sample_instances(seed, prog.batch, cell.settings["reference_instances"])
        sequences = {i: prog.host_scans(i) for i in sample}
        stamps, trajs = prog.stamps, prog.trajs
        del prog, carry, out
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = check.run_reference(yaml_path, sequences, stamps)
        t2 = time.perf_counter()
        found = check.numbers(episode, ref, trajs)
        print(json.dumps(dict(workload=args.workload, seed=seed, side="program", sample=sample, numbers=found,
                              program_s=t1 - t0, reference_s=t2 - t1)), flush=True)
        if args.control:
            ctl = check.run_reference(yaml_path, sequences, stamps, registration=False)
            found = check.numbers(control_rows([ctl[i] for i in sample]), {j: ref[i] for j, i in enumerate(sample)},
                                  [trajs[i] for i in sample])
            print(json.dumps(dict(workload=args.workload, seed=seed, side="control", sample=sample, numbers=found,
                                  control_s=time.perf_counter() - t2)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
