"""The port's VMAF harness (crfp_torch/eval/vmaf.py) against the JAX
package's (crfp_tpu/eval/vmaf.py) with a stub ``ffmpeg`` on a temporary
``PATH``: the stub records its argv and prints a score line to standard
error, as ffmpeg's libvmaf filter does. Both harnesses pass the same argv
and return the same float; a missing binary and output without a score
raise ``RuntimeError``."""

import json
import os
import stat
import sys

import pytest

_STUB = """#!{python}
import json, sys
with open({log!r}, "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
sys.stderr.write({err!r})
"""


def _stub(tmp_path, err: str):
    """A directory holding an executable ``ffmpeg`` that logs its argv to
    ``argv.log`` and writes ``err`` to standard error; (dir, log path)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "argv.log"
    exe = bin_dir / "ffmpeg"
    exe.write_text(_STUB.format(python=sys.executable, log=str(log), err=err))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return str(bin_dir), log


@pytest.mark.parametrize("line", ["[libvmaf @ 0x5] VMAF score: 87.654321\n",
                                  "VMAF score=93.5\n"], ids=["colon", "equals"])
def test_score_and_argv_match_jax(tmp_path, monkeypatch, line):
    from crfp_torch.eval import vmaf as port
    from crfp_tpu.eval import vmaf as ref

    bin_dir, log = _stub(tmp_path, "frame=  24 fps=0.0\n" + line)
    monkeypatch.setenv("PATH", bin_dir + os.pathsep + os.environ.get("PATH", ""))
    assert port.ffmpeg_available() and ref.ffmpeg_available()
    got = port.vmaf_score("sr.mp4", "gt.mp4", width=640, height=360, fps=30)
    want = ref.vmaf_score("sr.mp4", "gt.mp4", width=640, height=360, fps=30)
    assert got == want == float(line.split("VMAF score")[1].strip(":= \n"))
    argvs = [json.loads(a) for a in log.read_text().splitlines()]
    assert len(argvs) == 2 and argvs[0] == argvs[1]
    assert argvs[0] == port.vmaf_command("sr.mp4", "gt.mp4", 640, 360, 30)[1:]
    assert "[0:v]scale=640:360:flags=bicubic,fps=30[sr];" in argvs[0][5]
    # the defaults: 1280x720 at 24 fps, as test_video_quality.sh
    assert port.vmaf_score("a", "b") == ref.vmaf_score("a", "b")
    argvs = [json.loads(a) for a in log.read_text().splitlines()]
    assert argvs[2] == argvs[3] and "scale=1280:720" in argvs[2][5] and "fps=24" in argvs[2][5]


def test_missing_binary_raises(tmp_path, monkeypatch):
    from crfp_torch.eval import vmaf as port

    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg there
    assert not port.ffmpeg_available()
    with pytest.raises(RuntimeError, match="ffmpeg \\(with libvmaf\\) is required"):
        port.vmaf_score("sr.mp4", "gt.mp4")


def test_unparseable_output_raises(tmp_path, monkeypatch):
    from crfp_torch.eval import vmaf as port
    from crfp_tpu.eval import vmaf as ref

    bin_dir, _ = _stub(tmp_path, "Error: libvmaf filter not found\n")
    monkeypatch.setenv("PATH", bin_dir + os.pathsep + os.environ.get("PATH", ""))
    for mod in (port, ref):
        with pytest.raises(RuntimeError, match="could not parse VMAF score"):
            mod.vmaf_score("sr.mp4", "gt.mp4")
