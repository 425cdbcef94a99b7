"""The kernel library's build bookkeeping (libdogleg_tpu_torch/native/loader.py),
checked without nvcc: every csrc/*.cu goes into the one hash-named library,
and editing any source or shared header names a new library, so a stale build is never
loaded."""

import shutil

from libdogleg_tpu_torch.native import loader


def test_every_source_is_built():
    names = [s.name for s in loader._sources()]
    assert names == ["batchchol.cu", "bcsr.cu", "mega.cu", "panelchol.cu",
                     "segsum.cu", "tilechol.cu"]


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


def test_launcher_build_command_formed_without_compiling(tmp_path,
                                                         monkeypatch):
    """K1's launcher (csrc/launch.cpp) is one g++ command: the source
    against PyTorch's and Python's headers with PyTorch's C++ ABI, linked
    to PyTorch's libraries, into the hash-named module under the build
    directory; a second build finds the first and runs nothing."""
    import pathlib
    import sysconfig

    import torch
    from torch.utils import cpp_extension
    monkeypatch.setattr(loader, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "_gxx", lambda: "/usr/bin/g++")
    cmds = []

    def compiled(batch):
        for cmd in batch:
            cmds.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return [""] * len(batch)
    monkeypatch.setattr(loader, "_run", compiled)
    info = loader.build_launcher()
    flags, libs = loader.launcher_flags()
    (cmd,) = cmds
    out = cmd.index("-o")
    assert cmd[:out] == ["/usr/bin/g++", *flags, str(loader.LAUNCH_SOURCE)]
    assert tuple(cmd[out + 2:]) == libs
    assert info.path == loader.launcher_path() and info.path.exists()
    assert info.path.parent == tmp_path
    assert info.path.name.startswith(loader.LAUNCH_MODULE + "_")
    assert set(loader.LAUNCH_FLAGS) <= set(flags) and "-shared" in flags
    assert (f"-D_GLIBCXX_USE_CXX11_ABI="
            f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}") in flags
    # the paths torch.utils.cpp_extension gives for a C++ extension
    for path in (cpp_extension.include_paths()[0],
                 sysconfig.get_paths()["include"]):
        assert f"-I{pathlib.Path(path).resolve()}" in flags
    assert {"-lc10", "-ltorch_cpu", "-ltorch_python"} <= set(libs)
    lib = pathlib.Path(cpp_extension.library_paths()[0]).resolve()
    assert f"-L{lib}" in libs
    again = loader.build_launcher()
    assert again == (info.path, 0.0, "") and len(cmds) == 1


def test_launcher_name_follows_source_flags_and_torch(tmp_path, monkeypatch):
    """The launcher's build is found again only for the same source, flags,
    PyTorch and Python: each differs in the name."""
    import torch
    original = loader.launcher_path()
    assert loader.launcher_path() == original
    names = {original.name}
    monkeypatch.setattr(torch, "__version__", torch.__version__ + ".other")
    names.add(loader.launcher_path().name)
    monkeypatch.undo()
    monkeypatch.setattr(loader, "LAUNCH_FLAGS", loader.LAUNCH_FLAGS + ("-g",))
    names.add(loader.launcher_path().name)
    monkeypatch.undo()
    source = tmp_path / "launch.cpp"
    source.write_text(loader.LAUNCH_SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(loader, "LAUNCH_SOURCE", source)
    names.add(loader.launcher_path().name)
    monkeypatch.undo()
    assert len(names) == 4 and loader.launcher_path() == original
