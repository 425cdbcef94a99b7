"""The kernel library's build bookkeeping (libdogleg_tpu_torch/native/loader.py),
checked without nvcc: every csrc/*.cu goes into the one hash-named library,
and editing any source or shared header names a new library, so a stale build is never
loaded."""

import shutil

from libdogleg_tpu_torch.native import loader


def test_every_source_is_built():
    names = [s.name for s in loader._sources()]
    assert names == ["batchchol.cu", "bcsr.cu", "mega.cu", "panelchol.cu",
                     "tilechol.cu"]


def test_source_edit_renames_the_library(tmp_path, monkeypatch):
    original = loader.library_path()
    assert original.parent == loader._BUILD_DIR
    for s in loader._SRC.glob("*.cu*"):
        shutil.copy(s, tmp_path / s.name)
    monkeypatch.setattr(loader, "_SRC", tmp_path)
    assert loader.library_path() == original   # same sources, same name
    names = {original.name}
    edited = sorted(tmp_path.glob("*.cu*"))
    assert any(s.suffix == ".cuh" for s in edited)
    for s in edited:
        s.write_text(s.read_text() + "\n// edited\n")
        names.add(loader.library_path().name)
    assert len(names) == len(edited) + 1   # each edit gave a new name


def test_launch_target_takes_the_stream_handle_either_way(monkeypatch):
    """The stream handle comes from the runtime binding where PyTorch has
    it, and from torch.cuda.current_stream where it has not: the same
    handle, and never a missing attribute."""
    import types

    import torch
    dev = torch.device("cuda", 1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    assert loader.launch_target(dev) == (1, 1001)
    assert loader.launch_target(torch.device("cuda")) == (0, 1000)
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream")
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda index: types.SimpleNamespace(cuda_stream=2000 + index))
    assert loader.launch_target(dev) == (1, 2001)
