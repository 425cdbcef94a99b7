"""The kernel library's build bookkeeping (libdogleg_tpu_torch/native/loader.py),
checked without nvcc: every csrc/*.cu goes into the one hash-named library,
and editing any source names a new library, so a stale build is never
loaded."""

import shutil

from libdogleg_tpu_torch.native import loader


def test_every_source_is_built():
    names = [s.name for s in loader._sources()]
    assert names == ["bcsr.cu", "mega.cu", "panelchol.cu", "tilechol.cu"]


def test_source_edit_renames_the_library(tmp_path, monkeypatch):
    original = loader.library_path()
    assert original.parent == loader._BUILD_DIR
    for s in loader._sources():
        shutil.copy(s, tmp_path / s.name)
    monkeypatch.setattr(loader, "_SRC", tmp_path)
    assert loader.library_path() == original   # same sources, same name
    names = {original.name}
    for s in sorted(tmp_path.glob("*.cu")):
        s.write_text(s.read_text() + "\n// edited\n")
        names.add(loader.library_path().name)
    assert len(names) == 5   # each edit gave a new name
