"""Preset file loader (src/presets_loader.c).

INI-ish format: `[preset:name]` sections, `key = value` lines, `#`/`;`
comments.  Search order: $IQ_TOOL_TPU_PRESETS, cwd, $XDG_CONFIG_HOME/
iq_tool/, ~/.config/iq_tool/, package data dir.  The reference's
"multiple files found -> load none" conflict rule is preserved
(presets_loader.c:136-178): ambiguity is worse than absence.
"""

from __future__ import annotations

import dataclasses
import os

PRESETS_FILENAME = "iq_tool_presets.conf"

# the 16 recognized keys (presets_loader.c:32-50)
_KEYS = {
    "description": str,
    "target_rate": float,
    "output_sample_format_name": str,
    "gain-multiplier": float,
    "dc_block": bool,
    "iq_correction": bool,
    "agc_profile": str,
    "agc_target": float,
    "lowpass": float,
    "highpass": float,
    "pass_range": str,
    "stopband": str,
    "transition_width": float,
    "filter_taps": int,
    "attenuation": float,
    "filter_type": str,
}


@dataclasses.dataclass
class Preset:
    name: str
    values: dict


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def parse_presets_text(text: str) -> dict[str, Preset]:
    presets: dict[str, Preset] = {}
    current: Preset | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise ValueError(f"line {lineno}: malformed section {line!r}")
            sec = line[1:-1]
            if sec.lower().startswith("preset:"):
                name = sec.split(":", 1)[1].strip()
                current = Preset(name=name, values={})
                presets[name.lower()] = current
            else:
                current = None
            continue
        if current is None or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if key not in _KEYS:
            continue  # unknown keys ignored (forward compatible)
        typ = _KEYS[key]
        try:
            current.values[key] = _parse_bool(val) if typ is bool else typ(val)
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad value for '{key}': {val!r}") from None
    return presets


def _search_paths() -> list[str]:
    paths = []
    env = os.environ.get("IQ_TOOL_TPU_PRESETS")
    if env:
        paths.append(env)
    paths.append(os.path.join(os.getcwd(), PRESETS_FILENAME))
    xdg = os.environ.get("XDG_CONFIG_HOME") or os.path.expanduser("~/.config")
    paths.append(os.path.join(xdg, "iq_tool", PRESETS_FILENAME))
    paths.append(os.path.join(os.path.dirname(__file__), "data",
                              PRESETS_FILENAME))
    return paths


def load_presets() -> tuple[dict[str, Preset], str | None]:
    """Returns (presets, path).  Multiple user-level files found -> load
    none and return ({}, None), matching presets_loader.c:136-178 (the
    package-data fallback never conflicts)."""
    candidates = [p for p in _search_paths()[:-1] if os.path.isfile(p)]
    # the same physical file reachable via two search paths (env var
    # pointing at the cwd copy) is not a conflict
    candidates = list(dict.fromkeys(os.path.realpath(p) for p in candidates))
    if len(candidates) > 1:
        return {}, None
    path = candidates[0] if candidates else _search_paths()[-1]
    if not os.path.isfile(path):
        return {}, None
    with open(path, encoding="utf-8") as f:
        return parse_presets_text(f.read()), path
