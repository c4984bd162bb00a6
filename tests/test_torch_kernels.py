"""The kernel build of the port (``kernels.build``) without a GPU.

A stand-in ``nvcc`` (a shell script) logs each call and writes its output
file, so the CPU can check how the library is built: one compile per
``csrc/*.cu`` source, all started before any ends, then one link into the
hashed library name; a second build reuses it; a failed compile raises
with the compiler's output.  The real compile runs on the card
(``chip_smoke.py`` phase 1).
"""

import os
import stat
import textwrap

import pytest

from artdeco_tpu_torch import kernels

FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    log="$(dirname "$0")/calls.log"
    out=""; prev=""; src=""
    for a in "$@"; do
        [ "$prev" = "-o" ] && out="$a"
        case "$a" in *.cu) src="$a";; esac
        prev="$a"
    done
    echo "start $src" >> "$log"
    case "$src" in *broken.cu) echo "error: broken source"; exit 1;; esac
    [ -n "$src" ] && sleep 0.3
    echo "ptxas info    : Used 7 registers ($src)"
    echo "binary" > "$out"
    echo "end $src" >> "$log"
""")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return csrc, bin_dir / "calls.log"


def test_sources_compile_in_parallel_then_link(fake_build):
    csrc, log = fake_build
    path, out = kernels.build()
    assert path == kernels.library_path() and path.read_text() == "binary\n"
    assert out.count("ptxas info") == 4          # three compiles and the link
    calls = log.read_text().split("\n")[:-1]
    compiles = [c for c in calls if c.endswith(".cu")]
    assert sorted(os.path.basename(c.split()[1]) for c in compiles if c.startswith("start")) \
        == ["a.cu", "b.cu", "c.cu"]
    # every compile started before the first one ended
    first_end = next(i for i, c in enumerate(calls) if c.startswith("end"))
    assert sum(c.startswith("start") and c.endswith(".cu") for c in calls[:first_end]) == 3
    assert calls[-2:] == ["start ", "end "]       # then the link, with no source
    assert os.listdir(path.parent) == [path.name]   # no object or temporary left

    log.unlink()
    assert kernels.build() == (path, "")            # built once, then reused
    assert not log.exists()


def test_edited_source_rebuilds_and_failed_compile_raises(fake_build):
    csrc, _ = fake_build
    first, _ = kernels.build()
    (csrc / "broken.cu").write_text("// does not compile\n")
    assert kernels.library_path() != first           # the hash covers every source
    with pytest.raises(RuntimeError, match="broken source"):
        kernels.build()
    assert not kernels.library_path().exists()
    assert os.listdir(first.parent) == [first.name]
