"""TUM trajectory file I/O.

Format (one pose per line): ``t x y z qx qy qz qw`` — what the reference
emits via ``saveToTextFile_TUM`` (module/src/LidarOdometry.cpp:1877,
apps/mola-lidar-odometry-cli.cpp:530) and what kitti-metrics-eval / evo
consume.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np


def save_tum(path: Union[str, Path], stamps: np.ndarray, t: np.ndarray, quat_xyzw: np.ndarray) -> None:
    """Write poses: stamps (F,), translations (F,3), quaternions (F,4) xyzw."""
    with open(path, "w") as f:
        for i in range(len(stamps)):
            f.write(
                "%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                % (
                    stamps[i],
                    t[i, 0], t[i, 1], t[i, 2],
                    quat_xyzw[i, 0], quat_xyzw[i, 1], quat_xyzw[i, 2], quat_xyzw[i, 3],
                )
            )


def load_tum(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM file -> (stamps (F,), translations (F,3), quats (F,4) xyzw).

    Skips comment lines; tolerates comma separators.
    """
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip().replace(",", " ")
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        if len(vals) >= 8:
            rows.append(vals[:8])
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]
