"""The port's kernel build (ops/_build.py), without a compiler: which
sources it finds, how a library's name tracks its source, and that a
built library is reused rather than rebuilt."""

from livecell_tpu_torch.ops import _build


def test_sources_lists_the_kernels():
    assert "roi_align" in _build.sources()


def fake_csrc(tmp_path, monkeypatch, text="// v1\n"):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text(text)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    return csrc, build


def test_library_path_tracks_source(tmp_path, monkeypatch):
    csrc, build = fake_csrc(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert first.parent == build and first.name.startswith("libk-")
    assert _build.library_path("k") == first
    (csrc / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first
    (csrc / "k.cu").write_text("// v1\n")
    (csrc / "common.cuh").write_text("// shared header\n")
    assert _build.library_path("k") != first     # headers count too


def test_build_all_reuses_built_library(tmp_path, monkeypatch):
    fake_csrc(tmp_path, monkeypatch)
    lib = _build.library_path("k")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")

    def no_compiler():
        raise AssertionError("nvcc must not run for a built library")

    monkeypatch.setattr(_build, "_nvcc", no_compiler)
    assert _build.build_all() == {}
