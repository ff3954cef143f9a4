"""The storage-plugin extension contract, held against the JAX package.

One minimal third-party plugin, implementing only ``write``, ``read`` and
``delete`` over a directory, is subclassed from each package's
``StoragePlugin``: it instantiates, its ``sync_*`` forms run without an
event loop, and the default ``write_stream`` (``BufferedWriteStream``)
commits exactly its appends and lands nothing when aborted. Registered
through a ``.dist-info`` folder on ``sys.path`` under each package's
entry-point group, as an installed package would register it, it carries
the same numpy tree through both packages to the same files, each package
restores the other's snapshot bit-exactly, and a torn write over it aborts
alike in both.
"""

import asyncio
import importlib
import json
import os
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import io_types as jio
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import io_types as tio
from torchsnapshot_tpu_torch import storage_plugin as tsp
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError as TAborted
from torchsnapshot_tpu_torch.utils import knobs as tknobs

from test_torch_format import _files, _metadata, _normalized

PKGS = ("jax", "torch")
BASES = {"jax": jio, "torch": tio}
GROUPS = {"jax": "torchsnapshot_tpu.storage_plugins", "torch": "torchsnapshot_tpu_torch.storage_plugins"}

# The plugin a third party would ship: write, read and delete, nothing else.
# The JAX package hands ``read`` a BytesIO to fill; the port takes the
# bytes in ``read_io.buf``.
PLUGIN_SOURCE = textwrap.dedent(
    '''
    import os


    def make(base):
        class MinimalPlugin(base):
            def __init__(self, root):
                self.root = root

            def _abs(self, path):
                return os.path.join(self.root, path)

            async def write(self, write_io):
                path = self._abs(write_io.path)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path + ".part", "wb") as f:
                    f.write(write_io.buf)
                os.replace(path + ".part", path)

            async def read(self, read_io):
                with open(self._abs(read_io.path), "rb") as f:
                    if read_io.byte_range is None:
                        data = f.read()
                    else:
                        begin, end = read_io.byte_range
                        f.seek(begin)
                        data = f.read(end - begin)
                if hasattr(read_io.buf, "write"):
                    read_io.buf.write(data)
                else:
                    read_io.buf = data

            async def delete(self, path):
                os.remove(self._abs(path))

        return MinimalPlugin
    '''
)


@pytest.fixture(scope="module")
def plugin_dir(tmp_path_factory):
    """A directory holding the plugin's modules and a ``.dist-info`` that
    registers them as protocol ``minimal`` in both entry-point groups."""
    root = tmp_path_factory.mktemp("site")
    (root / "tss_minimal_plugin.py").write_text(PLUGIN_SOURCE)
    for pkg, mod in (("jax", "torchsnapshot_tpu.io_types"), ("torch", "torchsnapshot_tpu_torch.io_types")):
        (root / f"tss_minimal_plugin_{pkg}.py").write_text(
            f"import {mod} as base\nfrom tss_minimal_plugin import make\n\nMinimalPlugin = make(base.StoragePlugin)\n"
        )
    info = root / "tss_minimal_plugin-1.0.dist-info"
    info.mkdir()
    (info / "METADATA").write_text("Metadata-Version: 2.1\nName: tss-minimal-plugin\nVersion: 1.0\n")
    (info / "entry_points.txt").write_text(
        "".join(f"[{GROUPS[pkg]}]\nminimal = tss_minimal_plugin_{pkg}:MinimalPlugin\n\n" for pkg in PKGS)
    )
    return root


@pytest.fixture
def registered(plugin_dir, monkeypatch):
    monkeypatch.syspath_prepend(str(plugin_dir))
    importlib.invalidate_caches()
    return {pkg: importlib.import_module(f"tss_minimal_plugin_{pkg}").MinimalPlugin for pkg in PKGS}


@pytest.fixture(autouse=True)
def _pin_digests(monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")


def _read(plugin, path):
    read_io = (jio if isinstance(plugin, jio.StoragePlugin) else tio).ReadIO(path=path)
    plugin.sync_read(read_io)
    buf = read_io.buf
    return buf.getvalue() if hasattr(buf, "getvalue") else bytes(buf)


@pytest.mark.parametrize("pkg", PKGS)
def test_minimal_plugin_instantiates_and_runs_without_a_loop(registered, tmp_path, pkg):
    plugin = registered[pkg](str(tmp_path))
    plugin.sync_write(BASES[pkg].WriteIO(path="a/b", buf=b"hello"))
    assert _read(plugin, "a/b") == b"hello"
    plugin.sync_close()
    loop = asyncio.new_event_loop()
    try:
        plugin.sync_write(BASES[pkg].WriteIO(path="c", buf=memoryview(b"xyz")), loop)
        plugin.sync_close(loop)
    finally:
        loop.close()
    assert _read(plugin, "c") == b"xyz"


@pytest.mark.parametrize("pkg", PKGS)
def test_buffered_stream_commits_exactly_its_appends(registered, tmp_path, pkg):
    plugin = registered[pkg](str(tmp_path))
    later = bytearray(b"cd")

    async def run():
        stream = await plugin.write_stream("s/obj")
        assert isinstance(stream, BASES[pkg].BufferedWriteStream)
        await stream.append(b"ab")
        await stream.append(later)
        # Appends are kept as they are, not copied: the buffer is the
        # caller's until the stream ends.
        later[:] = b"CD"
        assert not os.path.exists(tmp_path / "s" / "obj")
        await stream.commit()
        aborted = await plugin.write_stream("s/gone")
        await aborted.append(b"zz")
        await aborted.abort()

    asyncio.run(run())
    assert _read(plugin, "s/obj") == b"abCD"
    with pytest.raises(FileNotFoundError):
        _read(plugin, "s/gone")
    assert sorted(os.listdir(tmp_path / "s")) == ["obj"]


def test_url_to_storage_plugin_takes_the_jax_parameter_names(registered, tmp_path):
    url = f"minimal://{tmp_path}"
    for plugin in (
        tsp.url_to_storage_plugin(url_path=url),
        tsp.url_to_storage_plugin(url),
        tsp.url_to_storage_plugin_in_event_loop(url),
        tsp.url_to_storage_plugin_in_event_loop(url_path=url, event_loop=None),
    ):
        assert isinstance(plugin, registered["torch"])


# ---------------------------------------------------------------------------
# Through the entry-point group, both packages
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 48)).astype(ml_dtypes.bfloat16),
        "b": rng.standard_normal(48).astype(np.float32),
        "i64": rng.integers(-(2**40), 2**40, 9).astype(np.int64),
        "c64": (rng.standard_normal(5) + 1j * rng.standard_normal(5)).astype(np.complex64),
        "f8": rng.standard_normal(11).astype(ml_dtypes.float8_e4m3fn),
        "step": seed,
        "name": "run",
    }


def _app(pkg, tree):
    if pkg == "jax":
        return {"m": jts.StateDict(tree)}
    return {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))}


def _zeros(pkg, tree):
    if pkg == "jax":
        return {"m": jts.StateDict({k: np.zeros_like(v) if isinstance(v, np.ndarray) else None for k, v in tree.items()})}
    t = from_numpy_tree(tree, device="cpu")
    return {"m": tts.StateDict({k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else None for k, v in t.items()})}


def _assert_tree(got, tree):
    for k, want in tree.items():
        v = got["m"][k]
        if isinstance(want, np.ndarray):
            raw = v.contiguous().view(-1).view(torch.uint8).numpy() if isinstance(v, torch.Tensor) else np.asarray(v).view(np.uint8)
            assert np.array_equal(raw.reshape(-1), want.reshape(-1).view(np.uint8)), k
        else:
            assert v == want, k


def _snap(pkg):
    return jts.Snapshot if pkg == "jax" else tts.Snapshot


def _restore(pkg, url, tgt):
    if pkg == "jax":
        jts.Snapshot(url).restore(tgt)
    else:
        tts.Snapshot(url).restore(tgt, device="cpu")


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
def test_entry_point_plugin_same_files_and_cross_restore(registered, tmp_path, monkeypatch, batching):
    for prefix in ("TORCHSNAPSHOT_TPU_", "TSS_TORCH_"):
        monkeypatch.setenv(prefix + "ENABLE_BATCHING", "1" if batching else "0")
        # Streams are never opened through a plugin without
        # supports_streaming, even when asked for.
        monkeypatch.setenv(prefix + "STREAM_WRITES", "1")
        monkeypatch.setenv(prefix + "STREAM_CHUNK_BYTES", "1024")
    for base in (jio, tio):
        monkeypatch.setattr(base.BufferedWriteStream, "append", _no_stream)
    tree = _tree(3)
    dirs = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    for pkg in PKGS:
        snapshot = _snap(pkg).take(f"minimal://{dirs[pkg]}", _app(pkg, tree))
        assert snapshot.verify() == {}
    (jmd, jnames), (tmd, tnames) = (_normalized(_metadata(dirs[pkg])) for pkg in PKGS)
    assert jmd == tmd
    files = {}
    for pkg, names in (("jax", jnames), ("torch", tnames)):
        files[pkg] = {names.get(p, p): b for p, b in _files(dirs[pkg]).items()}
        files[pkg].pop(".snapshot_metadata")
        for p in [p for p in files[pkg] if p.startswith(".telemetry")]:
            files[pkg].pop(p)
        # The sidecar names slabs by their random uuids too.
        sidecar = json.loads(files[pkg].pop(".checksums.0"))
        files[pkg][".checksums.0"] = {names.get(p, p): rec for p, rec in sidecar.items()}
    jfiles, tfiles = files["jax"], files["torch"]
    assert jfiles == tfiles
    assert not any(p.endswith(".part") for p in tfiles)
    # Each package restores the other's snapshot, through the plugin.
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        tgt = _zeros(reader, tree)
        _restore(reader, f"minimal://{dirs[writer]}", tgt)
        _assert_tree(tgt, tree)


async def _no_stream(self, buf):
    raise AssertionError("the scheduler streamed through the buffered default")


def _outcome(pkg, fn):
    try:
        fn()
        return ("commit",)
    except (jts.CheckpointAbortedError, TAborted) as e:
        assert isinstance(e, TAborted if pkg == "torch" else jts.CheckpointAbortedError)
        root = e.__cause__ if e.__cause__ is not None else e
        return ("abort", type(root).__name__, str(root), e.rank, e.phase)


def test_torn_write_over_the_plugin_aborts_alike(registered, tmp_path):
    """The fault injector's torn write opens the plugin's default stream,
    appends part of the object and stops: the take aborts in the write
    phase of rank 0, nothing of the torn object lands, and no
    ``.snapshot_metadata`` is written, in both packages."""
    spec = "op=write,kind=torn,bytes=64,path=0/m/w"
    tree = _tree(4)
    outs = {}
    for pkg, knobs in (("jax", jknobs), ("torch", tknobs)):
        url = f"minimal://{tmp_path / pkg}"
        with knobs.override_faults(spec):
            outs[pkg] = _outcome(pkg, lambda: _snap(pkg).take(url, _app(pkg, tree)))
        files = _files(str(tmp_path / pkg))
        assert ".snapshot_metadata" not in files
        assert not any(p.startswith("0/m/w") for p in files), sorted(files)
    assert outs["jax"] == outs["torch"] == ("abort", "InjectedFault", "injected torn write after 64 bytes: 0/m/w", 0, "write")
