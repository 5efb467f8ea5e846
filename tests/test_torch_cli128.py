"""The CLI file to file over many channels on the CPU: the lane of
``chip_smoke.py`` [cli128], which runs the same at 128 channels x 262144
frames on the card.  Eight '{ch}'-templated cs16 files of a seeded tone,
four full blocks and a partial one, through the flagship's flags.

Bounds: byte-identical.  The CLI's output is the chain stepped over the
same blocks (the engine pads the partial block with zeros and trims the
output to expected_out_frames), and a run cut after its second block and
resumed from its checkpoint is the uncut run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu_torch.cli import main as port_main  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain  # noqa: E402
from iq_tool_tpu_torch.profile_steps import config, tone_wire  # noqa: E402

CH, BLOCK = 8, 16384
FLAGSHIP = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
            "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
            "--dc-block", "--freq-shift", "100000", "--lowpass", "400000",
            "--channels", str(CH), "--block-size", str(BLOCK), "--device", "cpu",
            "--log-level", "warn"]


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """(directory, the (C, 2 * frames) int16 wire, the chain's block):
    in_{ch}.cs16 of 4.5 blocks each."""
    d = tmp_path_factory.mktemp("cli128")
    n_in = Chain(config("flagship", CH, BLOCK), device="cpu").n_in
    frames = 4 * n_in + n_in // 2
    wire = tone_wire(CH, frames, torch.Generator().manual_seed(14)).numpy()
    for c in range(CH):
        (d / f"in_{c}.cs16").write_bytes(wire[c].tobytes())
    return d, wire, n_in


def _stepped(wire: np.ndarray, n_in: int) -> np.ndarray:
    """The flagship Chain stepped over the blocks of ``wire``, the last
    zero-padded, its output trimmed as the engine trims it."""
    chain = Chain(config("flagship", CH, BLOCK), device="cpu")
    carry, outs = chain.init_carry(), []
    frames = wire.shape[1] // 2
    for k in range(0, frames, n_in):
        blk = np.zeros((CH, 2 * n_in), np.int16)
        part = wire[:, 2 * k:2 * (k + n_in)]
        blk[:, :part.shape[1]] = part
        carry, out = chain.step(carry, torch.from_numpy(blk))
        outs.append(out.numpy().copy())
    return np.concatenate(outs, axis=1)[:, :2 * chain.expected_out_frames(frames)]


def _outputs(d, stem):
    return [np.frombuffer((d / f"{stem}_{c}.cs16").read_bytes(), np.int16)
            for c in range(CH)]


def test_cli_channels_is_the_chain_stepped(stream):
    """Every channel's file is the chain stepped over the same blocks,
    byte for byte, with the frame count expected_out_frames gives."""
    d, wire, n_in = stream
    assert port_main([str(d / "in_{ch}.cs16"), str(d / "uncut_{ch}.cs16"), *FLAGSHIP,
                      "--force-overwrite"]) == 0
    want = _stepped(wire, n_in)
    got = _outputs(d, "uncut")
    for c in range(CH):
        assert got[c].tobytes() == want[c].tobytes(), f"channel {c}"


def test_cli_channels_cut_and_resume(stream):
    """The run cut after its second block (its inputs truncated there),
    with --checkpoint, then resumed with --resume on the whole files: each
    channel's file is the uncut run's, byte for byte."""
    d, wire, n_in = stream
    for c in range(CH):
        (d / f"half_{c}.cs16").write_bytes(wire[c, :4 * n_in].tobytes())
    ck = d / "state.ckpt"
    cut = [str(d / "half_{ch}.cs16"), str(d / "part_{ch}.cs16"), *FLAGSHIP,
           "--checkpoint", str(ck), "--force-overwrite"]
    assert port_main(cut) == 0
    half_out = Chain(config("flagship", CH, BLOCK), device="cpu").expected_out_frames(2 * n_in)
    assert all(len(o) == 2 * half_out for o in _outputs(d, "part"))
    resume = [str(d / "in_{ch}.cs16"), str(d / "part_{ch}.cs16"), *FLAGSHIP,
              "--checkpoint", str(ck), "--resume"]
    assert port_main(resume) == 0
    assert port_main([str(d / "in_{ch}.cs16"), str(d / "whole_{ch}.cs16"), *FLAGSHIP,
                      "--force-overwrite"]) == 0
    for c, (got, want) in enumerate(zip(_outputs(d, "part"), _outputs(d, "whole"))):
        assert got.tobytes() == want.tobytes(), f"channel {c}"
