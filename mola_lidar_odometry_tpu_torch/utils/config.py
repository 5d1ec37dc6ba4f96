"""YAML pipeline-config loader with the reference's extension syntax.

Reimplements the `mola_yaml` contract the reference pipelines rely on
(reference pipelines/lidar3d-default.yaml:9,41,44-48,158,233 and docs
"Configuring pipelines via environment variables"):

  * ``${ENV_VAR|default}``  — environment-variable substitution with default;
    nests (a default may itself contain ``$f{...}``).
  * ``${ENV_VAR}``          — required environment variable.
  * ``$f{expr}``            — formula; evaluated at load time when it has no
    runtime variables, otherwise left as an expression string for the
    runtime dynamic-variable system (utils/expr.Expr).
  * ``$include{path}``      — splice another YAML file (relative to the
    including file).

The result is plain Python dicts/lists/str/float; strings that look like
expressions are compiled downstream by the pipeline compilers via
``utils.expr.Expr`` and evaluated per frame on tensors —
the equivalent of mp2p_icp's ParameterSource.realize() re-evaluation
(reference module/src/LidarOdometry.cpp:1571-1635).

Port of ``mola_lidar_odometry_tpu/utils/config.py`` (the loader is
framework-free; only the ``Expr`` import differs).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Mapping, Optional, Union

import yaml

from mola_lidar_odometry_tpu_torch.utils.expr import Expr

__all__ = ["load_yaml_file", "load_yaml_text", "ConfigError"]


class ConfigError(ValueError):
    pass


def _find_closing(s: str, start: int) -> int:
    """Index of the '}' matching the '{' at ``start`` (handles nesting)."""
    depth = 0
    for i in range(start, len(s)):
        if s[i] == "{":
            depth += 1
        elif s[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    raise ConfigError(f"Unbalanced braces in: {s!r}")


def _substitute(text: str, env: Mapping[str, str]) -> str:
    """Expand ${VAR|default}, ${VAR} and $f{...} markers in raw YAML text."""
    out = []
    i = 0
    while i < len(text):
        j = text.find("$", i)
        if j < 0:
            out.append(text[i:])
            break
        out.append(text[i:j])
        if text.startswith("${", j):
            close = _find_closing(text, j + 1)
            body = text[j + 2 : close]
            # split on the FIRST top-level '|'
            depth = 0
            split = -1
            for k, ch in enumerate(body):
                if ch == "{":
                    depth += 1
                elif ch == "}":
                    depth -= 1
                elif ch == "|" and depth == 0:
                    split = k
                    break
            if split >= 0:
                name, default = body[:split], body[split + 1 :]
            else:
                name, default = body, None
            val = env.get(name)
            if val is None:
                if default is None:
                    raise ConfigError(f"Required environment variable {name!r} is not set")
                val = _substitute(default, env)
            out.append(val)
            i = close + 1
        elif text.startswith("$f{", j):
            close = _find_closing(text, j + 2)
            inner = _substitute(text[j + 3 : close], env)
            # Evaluate now if constant; else leave as a runtime expression.
            try:
                e = Expr(inner)
                out.append(repr(e.const_value()) if e.is_const else inner)
            except Exception:
                out.append(inner)
            i = close + 1
        elif text.startswith("$env{", j):
            close = _find_closing(text, j + 4)
            name = text[j + 5 : close].strip()
            out.append(env.get(name, ""))
            i = close + 1
        else:
            out.append("$")
            i = j + 1
    return "".join(out)


_INCLUDE_RE = re.compile(r"\$include\{([^}]*)\}")


def _expand_includes(text: str, base_dir: Path, env: Mapping[str, str]) -> str:
    def repl(m: "re.Match[str]") -> str:
        # Skip includes on commented-out lines.
        line_start = text.rfind("\n", 0, m.start()) + 1
        if text[line_start : m.start()].lstrip().startswith("#"):
            return m.group(0)
        rel = m.group(1).strip().strip("'\"")
        path = (base_dir / rel).resolve()
        sub = path.read_text()
        sub = _expand_includes(sub, path.parent, env)
        # The include site is a mapping value (`key: $include{...}`); emit the
        # included document as a nested block indented past the key's column.
        line_start = text.rfind("\n", 0, m.start()) + 1
        indent = " " * (m.start() - line_start + 2)
        body = "\n".join(indent + ln for ln in sub.splitlines())
        return "\n" + body

    return _INCLUDE_RE.sub(repl, text)


def load_yaml_text(
    text: str,
    env: Optional[Mapping[str, str]] = None,
    base_dir: Union[str, Path, None] = None,
) -> Any:
    env = dict(os.environ if env is None else env)
    base = Path(base_dir) if base_dir is not None else Path.cwd()
    # mola_yaml built-in: directory of the YAML file being parsed.
    env.setdefault("CURRENT_YAML_FILE_PATH", str(base))
    env.setdefault("HOME", os.path.expanduser("~"))
    text = _expand_includes(text, base, env)
    text = _substitute(text, env)
    return yaml.safe_load(text)


def load_yaml_file(path: Union[str, Path], env: Optional[Mapping[str, str]] = None) -> Any:
    p = Path(path)
    return load_yaml_text(p.read_text(), env=env, base_dir=p.parent)


# ---------------------------------------------------------------------------
# Small typed accessors used by the parameter-struct loaders.
# ---------------------------------------------------------------------------


def as_bool(v: Any, default: Optional[bool] = None) -> bool:
    if v is None and default is not None:
        return default
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    if isinstance(v, str):
        s = v.strip().strip("'\"").lower()
        if s in ("true", "1", "yes", "on"):
            return True
        if s in ("false", "0", "no", "off", ""):
            return False
    raise ConfigError(f"Cannot interpret {v!r} as bool")


def as_float(v: Any, default: Optional[float] = None) -> float:
    """Load-time float: accepts numbers and *constant* expressions."""
    if v is None and default is not None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return Expr(v.strip().strip("'\"")).const_value()
    raise ConfigError(f"Cannot interpret {v!r} as float")


def as_str(v: Any, default: Optional[str] = None) -> str:
    if v is None and default is not None:
        return default
    if isinstance(v, str):
        return v.strip().strip("'\"")
    raise ConfigError(f"Cannot interpret {v!r} as str")
