"""ops/cuda_build.py without nvcc: which command builds a kernel library,
where the library goes, that another source directory or an edited header
gives another library, and that the wrappers' entry points look their
library up at every call. The builds themselves run on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import os
import shutil
import types

import pytest

from eogs2_tpu_torch.ops import cuda_build


@pytest.fixture
def no_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")


def test_nvcc_command_takes_source_dir(no_nvcc, tmp_path):
    cmd = cuda_build.nvcc_command("fused_blend_bwd", "out.so", str(tmp_path))
    assert cmd[0] == "nvcc" and "-fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any(c.startswith("-D") for c in cmd)
    assert cmd[-3:] == ["-o", "out.so",
                        os.path.join(str(tmp_path), "fused_blend_bwd.cu")]
    assert cuda_build.nvcc_command("fused_blend_bwd", "out.so")[-1] == \
        os.path.join(cuda_build.CSRC, "fused_blend_bwd.cu")


def test_library_path_follows_sources_and_headers(tmp_path):
    lib = cuda_build.library_path
    default = lib("fused_blend_fwd")
    assert default == lib("fused_blend_fwd")
    assert os.path.dirname(default) == cuda_build.BUILD_DIR
    assert os.path.basename(default).startswith("libfused_blend_fwd-")
    assert lib("fused_blend_bwd") != default
    # a copy of csrc builds the same library; an edited header another
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    assert lib("fused_blend_fwd", str(copy)) == default
    with open(copy / "blend_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert lib("fused_blend_fwd", str(copy)) != default
    assert lib("blend_tiles_fwd", str(copy)) != lib("blend_tiles_fwd")


def test_load_builds_each_source_dir_once(monkeypatch):
    built, opened = [], []
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_build",
                        lambda *b: built.append(b) or f"lib{len(built)}")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or path)
    assert cuda_build.load("fused_blend_bwd") == "lib1"
    assert cuda_build.load("fused_blend_bwd") == "lib1"
    assert cuda_build.load("fused_blend_bwd", "/elsewhere") == "lib2"
    assert cuda_build.load("fused_blend_bwd", "/elsewhere") == "lib2"
    assert opened == ["lib1", "lib2"]
    assert set(cuda_build._libs) == {"fused_blend_bwd",
                                     ("fused_blend_bwd", "/elsewhere")}


def test_entry_looks_up_the_library_at_every_call(monkeypatch):
    """A library cached under a source's name is the one the next entry
    call returns: swapping builds (scripts/fused_blend_ab.py) relies on it."""
    def fake_lib(tag):
        return types.SimpleNamespace(
            eogs2_fused_blend_bwd=types.SimpleNamespace(tag=tag))

    monkeypatch.setattr(cuda_build, "_libs",
                        {"fused_blend_bwd": fake_lib("this")})
    first = cuda_build.entry("fused_blend_bwd", "eogs2_fused_blend_bwd", [])
    assert first.tag == "this" and first.argtypes == []
    cuda_build._libs["fused_blend_bwd"] = fake_lib("other")
    again = cuda_build.entry("fused_blend_bwd", "eogs2_fused_blend_bwd", [])
    assert again.tag == "other"


def test_build_log_survives_a_cached_build(no_nvcc, monkeypatch, tmp_path):
    """nvcc's report (ptxas's registers and spills) is kept beside the
    library, so a process that finds the library built still has it."""
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return types.SimpleNamespace(returncode=0, stdout="ptxas: 0 bytes "
                                     "spill stores", stderr="")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "build_logs", {})
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    so = cuda_build._build("blend_tiles_bwd")
    assert os.path.exists(so) and len(runs) == 1
    assert "spill" in cuda_build.build_logs["blend_tiles_bwd"]
    cuda_build.build_logs.clear()
    assert cuda_build._build("blend_tiles_bwd") == so and len(runs) == 1
    assert "spill" in cuda_build.build_logs["blend_tiles_bwd"]


def test_equal_sources_build_at_once(no_nvcc, monkeypatch, tmp_path):
    """Two trees with the same source hash to one library; building both
    at once (build_all's threads) must not collide on a temporary file."""
    import time

    def slow_nvcc(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("x")
        time.sleep(0.2)
        assert os.path.exists(out)  # nobody moved it meanwhile
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "build_logs", {})
    monkeypatch.setattr(cuda_build.subprocess, "run", slow_nvcc)
    builds = [("blend_tiles_fwd",), ("blend_tiles_fwd", str(copy))]
    assert cuda_build.library_path(*builds[0]) == \
        cuda_build.library_path(*builds[1])
    cuda_build.build_all(builds)
    base = os.path.basename(cuda_build.library_path(*builds[0]))[:-3]
    assert sorted(os.listdir(tmp_path / "build")) == [base + ".log",
                                                      base + ".so"]


def test_build_all_builds_every_source_by_default(monkeypatch):
    built = []
    monkeypatch.setattr(cuda_build, "_build", lambda *b: built.append(b))
    builds = cuda_build.build_all()
    assert sorted(built) == builds
    assert {b[0] for b in builds} >= {"fused_blend_fwd", "fused_blend_bwd",
                                      "blend_tiles_fwd", "blend_tiles_bwd"}
    built.clear()
    cuda_build.build_all([("fused_blend_fwd", "/elsewhere")])
    assert built == [("fused_blend_fwd", "/elsewhere")]
