"""emx_torch/ops/_build.py on the CPU, with a stand-in for nvcc: a shell
script that compiles the source as C with the system C compiler. It
checks what the build does around nvcc: one process per source, all
started together; libraries named by a hash of source and flags and
reused; a failure raised with the compiler's output and the other
processes stopped."""

import ctypes
import os
import shutil
import stat
import time

import pytest

from emx_torch.ops import _build

FAKE_NVCC = r"""#!/bin/sh
# Stand-in for nvcc: the last argument is the source, -o names the output.
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac
done
name=$(basename "$src")
echo "$name" >> "$FAKE_LOG/calls"
touch "$FAKE_LOG/started_$name"
# Wait (at most 20 s) until FAKE_PEERS compilers have started.
i=0
while [ "$(ls "$FAKE_LOG" | grep -c '^started_')" -lt "$FAKE_PEERS" ] \
      && [ $i -lt 200 ]; do sleep 0.1; i=$((i + 1)); done
[ $i -lt 200 ] && touch "$FAKE_LOG/overlapped_$name"
[ -n "$FAKE_HANG" ] && case "$name" in *ok*) exec sleep 30;; esac
exec cc -shared -fPIC -x c "$src" -o "$out"
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    if shutil.which("cc") is None:
        pytest.skip("needs a C compiler for the stand-in nvcc")
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    logs = tmp_path / "log"
    logs.mkdir()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_LOG", str(logs))
    monkeypatch.setenv("FAKE_PEERS", "1")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_built", {})
    return csrc, logs


def _source(csrc, name, value):
    (csrc / f"{name}.cu").write_text(f"int answer(void) {{ return {value}; }}\n")


def test_sources_build_together_and_load(fake, monkeypatch):
    csrc, logs = fake
    _source(csrc, "one", 1)
    _source(csrc, "two", 2)
    monkeypatch.setenv("FAKE_PEERS", "2")
    built = _build.load_all(["one", "two"])
    # Each compiler saw the other start before it finished.
    assert sorted(p.name for p in logs.iterdir()
                  if p.name.startswith("overlapped_")) == [
        "overlapped_one.cu", "overlapped_two.cu"]
    for name, want in (("one", 1), ("two", 2)):
        fn = built[name].lib.answer
        fn.restype = ctypes.c_int
        assert fn() == want
        assert built[name].seconds > 0
        assert built[name].path.parent == _build.BUILD_DIR


def test_built_library_is_reused(fake, monkeypatch):
    csrc, logs = fake
    _source(csrc, "one", 1)
    first = _build.load("one")
    assert _build.load("one") is first          # same process: cached
    monkeypatch.setattr(_build, "_built", {})   # a new process: on disk
    again = _build.load("one")
    assert again.path == first.path and again.seconds == 0.0
    assert (logs / "calls").read_text().split() == ["one.cu"]
    _source(csrc, "one", 7)                     # the hash covers the source
    monkeypatch.setattr(_build, "_built", {})
    assert _build.load("one").path != first.path


def test_failure_raises_and_stops_the_other_build(fake, monkeypatch):
    csrc, _ = fake
    (csrc / "bad.cu").write_text("this is not C\n")
    _source(csrc, "ok", 1)
    monkeypatch.setenv("FAKE_HANG", "1")   # "ok" would take 30 s more
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="nvcc failed on bad.cu"):
        _build.load_all(["bad", "ok"])
    assert time.perf_counter() - t0 < 20
    assert not any(p.suffix == ".so" for p in _build.BUILD_DIR.iterdir())


def test_nvcc_lookup(fake, monkeypatch):
    assert _build.nvcc() == os.path.join(os.environ["CUDA_HOME"], "bin",
                                         "nvcc")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    if not os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()
