"""The native engine's build: from the committed sources, atomic, and
loud when the compiler fails (native/__init__.py)."""

import ctypes

import pytest

from libdeflate_rsx_tpu import native


def test_engine_builds_from_committed_sources():
    assert native.get_lib() is not None
    assert native.get_ext() is not None


def test_failed_compile_raises_with_compiler_message(tmp_path):
    bad = tmp_path / "bad.c"
    bad.write_text("int broken( {\n")
    so = tmp_path / "bad.so"
    with pytest.raises(native.NativeBuildError, match="bad.c"):
        native._compile(str(so), [str(bad)], [])
    assert not so.exists()
    assert [p.name for p in tmp_path.iterdir()] == ["bad.c"]  # no temp left


def test_missing_compiler_raises(tmp_path, monkeypatch):
    src = tmp_path / "ok.c"
    src.write_text("int f(void) { return 1; }\n")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(native.NativeBuildError, match="cannot run"):
        native._compile(str(tmp_path / "ok.so"), [str(src)], [])


def test_compile_is_skipped_when_fresh(tmp_path):
    src = tmp_path / "good.c"
    src.write_text("int seven(void) { return 7; }\n")
    so = tmp_path / "good.so"
    native._compile(str(so), [str(src)], [])
    stamp = so.stat().st_mtime_ns
    native._compile(str(so), [str(src)], [])
    assert so.stat().st_mtime_ns == stamp
    assert ctypes.CDLL(str(so)).seven() == 7
