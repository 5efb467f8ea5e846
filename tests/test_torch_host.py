"""The port's copies of the reference's host modules (constants, formats,
presets, the input/output modules, io, utils) against the originals:
the port imports nothing of ``iq_tool_tpu``, so these tests are what
keeps the two equal.
"""

import argparse
import dataclasses
import os
import re

import pytest

torch = pytest.importorskip("torch")

import iq_tool_tpu  # noqa: E402
import iq_tool_tpu_torch  # noqa: E402
from iq_tool_tpu import constants as jc, formats as jf, modules as jm, presets as jp  # noqa: E402
from iq_tool_tpu_torch import constants as tc, formats as tf, modules as tm  # noqa: E402
from iq_tool_tpu_torch import presets as tp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each copied file, relative to either package's root
COPIED = (
    "constants.py", "formats.py", "presets.py", "data/iq_tool_presets.conf",
    "modules/__init__.py", "modules/base.py", "modules/input_rawfile.py",
    "modules/input_sdr.py", "modules/input_spyserver.py", "modules/input_tone.py",
    "modules/input_wav.py", "modules/output_raw.py", "modules/output_stdout.py",
    "modules/output_wav.py", "modules/sdrplay_api.py", "io/__init__.py",
    "io/metadata.py", "io/wav.py", "io/packets.py", "utils/__init__.py",
    "utils/log.py", "utils/ringbuffer.py", "utils/watchdog.py", "native.py",
)
_IMPORT = re.compile(r"^(\s*)(from|import) iq_tool_tpu([ .])", re.M)


def _read(pkg: str, rel: str) -> str:
    with open(os.path.join(REPO, pkg, rel), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_the_original(rel):
    """Each copy is the original with its imports pointed at the port."""
    want = _IMPORT.sub(r"\1\2 iq_tool_tpu_torch\3", _read("iq_tool_tpu", rel))
    got = _read("iq_tool_tpu_torch", rel)
    assert got == want


def test_no_import_of_the_jax_package():
    pat = re.compile(r"^\s*(from iq_tool_tpu[ .]|import iq_tool_tpu\b)", re.M)
    bad = []
    for root, _, files in os.walk(os.path.join(REPO, "iq_tool_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if pat.search(fh.read()):
                        bad.append(os.path.relpath(path, REPO))
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as fh:
        if pat.search(fh.read()):
            bad.append("chip_smoke.py")
    assert not bad


def test_version():
    assert iq_tool_tpu_torch.__version__ == iq_tool_tpu.__version__


def test_make_ring_picks_the_same_ring():
    """Both packages bind the one library ``native/`` builds: the port's
    live inputs get the C++ ring exactly when the reference's do, with
    the same lossy-write, drain-then-EOF semantics."""
    from iq_tool_tpu.utils import ringbuffer as jr
    from iq_tool_tpu_torch.utils import ringbuffer as tr
    want, got = jr.make_ring(16), tr.make_ring(16)
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__.startswith("iq_tool_tpu_torch.")
    for rb in (want, got):
        assert rb.write(b"0123456789") == 10
        assert rb.write(b"abcdefghij") == 6
        assert rb.read(16) == b"0123456789abcdef"
        rb.write(b"xy")
        rb.signal_end_of_stream()
        assert rb.read(10) == b"xy" and rb.read(10) == b"" and rb.end_of_stream


def _public_constants(mod):
    return {k: getattr(mod, k) for k in dir(mod) if k.isupper()}


def test_constants():
    want, got = _public_constants(jc), _public_constants(tc)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == v, k


@pytest.mark.parametrize("name", sorted(jf.FORMATS))
def test_format_table(name):
    want, got = jf.FORMATS[name], tf.FORMATS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.is_float, got.is_complex) == (want.is_float, want.is_complex)
    assert tf.get_format(name) is got


def test_format_names():
    assert list(tf.FORMATS) == list(jf.FORMATS)
    assert list(tf.complex_formats()) == list(jf.complex_formats())


def test_presets(tmp_path, monkeypatch):
    """The packaged presets parse the same (search paths pointed away
    from any user file, so both read their package data)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    monkeypatch.delenv("IQ_TOOL_TPU_PRESETS", raising=False)
    (want, wpath), (got, gpath) = jp.load_presets(), tp.load_presets()
    assert os.path.dirname(gpath) == os.path.join(REPO, "iq_tool_tpu_torch", "data")
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k


def _options(cls):
    parser = argparse.ArgumentParser(add_help=False)
    cls.add_cli_options(parser)
    return [(tuple(a.option_strings), a.dest, a.default, a.help, a.nargs,
             None if a.choices is None else tuple(a.choices),
             getattr(a.type, "__name__", a.type), type(a).__name__)
            for a in parser._actions]


def test_registered_module_names():
    assert sorted(tm.INPUT_MODULES) == sorted(jm.INPUT_MODULES)
    assert sorted(tm.OUTPUT_MODULES) == sorted(jm.OUTPUT_MODULES)


@pytest.mark.parametrize("name", sorted(jm.INPUT_MODULES))
def test_input_module_options(name):
    want, got = jm.INPUT_MODULES[name], tm.INPUT_MODULES[name]
    assert got.__module__.startswith("iq_tool_tpu_torch.")
    assert (got.name, got.is_realtime) == (want.name, want.is_realtime)
    assert _options(got) == _options(want)


@pytest.mark.parametrize("name", sorted(jm.OUTPUT_MODULES))
def test_output_module_options(name):
    want, got = jm.OUTPUT_MODULES[name], tm.OUTPUT_MODULES[name]
    assert got.__module__.startswith("iq_tool_tpu_torch.")
    assert (got.name, got.requires_output_path) == (want.name, want.requires_output_path)
    assert _options(got) == _options(want)
