"""The parity audit of the port against the JAX package, as two tables
that a test holds against the code. This file is the record of every
deliberate difference: a future difference is listed here, with its
reason, or the audit fails.

(a) Public names. Every public top-level function and class of each JAX
module, and every public method of those classes, has a counterpart of
the same name in the port module of the same path (an inherited method or
a property counts), or an entry in ``NAME_DIFFERENCES`` whose reason is
"JAX-only: ...", "renamed to `<port name>`: ..." (the name must resolve in
the port) or "internal helper, not public in the port: ...". An entry no
longer needed fails too. Names only: signatures are not compared (the
read pipeline's entry points take a consumer executor in the port, the
rank and pools in the JAX package; ``tests/test_torch_parity_scheduler.py``
calls each its own way).

(b) JAX test modules. Every module ``tests/test_*.py`` of the JAX package
maps to the port's test files that pin its behaviour over the port (each
file must exist, and a word of the behaviour must appear in one of them),
or to a reason: its benchmark harness is bench-only (the port has no
benchmark yet, ROADMAP A18a)."""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "torchsnapshot_tpu", "torchsnapshot_tpu_torch"

_INTERNAL_CHAIN = "internal helper, not public in the port: the pipelines set `Node.successor` directly"
_LANES = "internal helper, not public in the port: the port's lanes admit and release inside `run_to_host` and `submit_to_host`"
_STORE = "JAX-only: the port's coordinator rides torch.distributed's c10d store (`parallel.store.C10dStore`)"
_LAUNCH = "JAX-only: the port's coordinator rides torch.distributed's c10d store; rank, world size and address come from the process group"

NAME_DIFFERENCES = {
    "d2h.py:hint_copy_to_host": "JAX-only: `jax.Array.copy_to_host_async` has no torch counterpart; the port's early D2H is `TransferLanes.submit_to_host`",
    "d2h.py:TransferLanes.bind_budget": _LANES,
    "d2h.py:TransferLanes.executor": _LANES,
    "d2h.py:TransferLanes.outstanding_bytes": _LANES,
    "d2h.py:TransferLanes.try_admit": _LANES,
    "d2h.py:TransferLanes.release": _LANES,
    "d2h.py:TransferLanes.release_all": _LANES,
    "d2h.py:TransferLanes.start": _LANES,
    "io_preparer.py:HostCapturedArray": "JAX-only: wraps the host shards of a jax.Array; the port's host capture is a private CPU tensor",
    "io_preparer.py:HostCapturedArray.assembled_local": "JAX-only: wraps the host shards of a jax.Array; the port's host capture is a private CPU tensor",
    "scheduler.py:PipelinePools.consuming_executor": "internal helper, not public in the port: each read pipeline sizes its own consumer pool",
    "engine/executor.py:NodeContext.reservation": "internal helper, not public in the port: an instance attribute of `NodeContext` (a property in the JAX package)",
    "parallel/store.py:JaxCoordinationStore": _STORE,
    "parallel/store.py:JaxCoordinationStore.available": _STORE,
    "parallel/store.py:JaxCoordinationStore.set": _STORE,
    "parallel/store.py:JaxCoordinationStore.get": _STORE,
    "parallel/store.py:JaxCoordinationStore.try_get": _STORE,
    "parallel/store.py:JaxCoordinationStore.add": _STORE,
    "parallel/store.py:JaxCoordinationStore.delete": _STORE,
    "io_preparers/array.py:to_host": "JAX-only: an asynchronous `np.asarray` of a jax.Array; the port stages through `ArrayBufferStager` on the D2H lanes",
    "io_preparers/array.py:entry_np_dtype": "internal helper, not public in the port: entries map to torch dtypes through `serialization.string_to_dtype`",
    "io_preparers/array.py:ArrayBufferConsumer": "renamed to `io_preparers.array.ByteRangeConsumer`: raw payloads; compressed ones go through `FramedSliceConsumer`",
    "io_preparers/array.py:ArrayBufferConsumer.consume_buffer": "renamed to `io_preparers.array.ByteRangeConsumer.consume_buffer`",
    "io_preparers/array.py:ArrayBufferConsumer.get_consuming_cost_bytes": "renamed to `io_preparers.array.ByteRangeConsumer.get_consuming_cost_bytes`",
    "io_preparers/array.py:ChunkedReadConsumer": "renamed to `io_preparers.array.ByteRangeConsumer`: a row chunk is a byte range of its target",
    "io_preparers/array.py:ChunkedReadConsumer.consume_buffer": "renamed to `io_preparers.array.ByteRangeConsumer.consume_buffer`",
    "io_preparers/array.py:ChunkedReadConsumer.get_consuming_cost_bytes": "renamed to `io_preparers.array.ByteRangeConsumer.get_consuming_cost_bytes`",
    "engine/graph.py:Node.then": _INTERNAL_CHAIN,
    "engine/graph.py:Node.chain": _INTERNAL_CHAIN,
    "partitioner.py:partition_write_reqs": "internal helper, not public in the port: the take calls `partition_write_reqs_with_assignment`, which also returns the assignment",
    "io_preparers/sharded_array.py:index_to_offsets_sizes": "internal helper, not public in the port: a DTensor's shard offsets come from `compute_local_shape_and_global_offset`, not from a slice index",
    "native/__init__.py:supports_write_at": "internal helper, not public in the port: the port loads only an engine of its ABI (`native.ABI_VERSION`, checked at load), which always has the positioned write",
    "io_preparers/sharded_array.py:assemble_jax_array": "JAX-only: builds a jax.Array; the port's counterpart is `assemble_dtensor`",
    "utils/knobs.py:get_store_addr": _LAUNCH,
    "utils/knobs.py:get_env_rank": _LAUNCH,
    "utils/knobs.py:get_env_world_size": _LAUNCH,
    "utils/knobs.py:set_coordinator_env": _LAUNCH,
    "utils/knobs.py:get_launcher_drain_s": "JAX-only: the JAX package's test launcher's setting",
    "utils/lru.py": "JAX-only: the module caches jitted XLA programs, which the port has none of",
}

_PREFIXES = ("JAX-only: ", "renamed to `", "internal helper, not public in the port: ")


def _jax_modules():
    root = os.path.join(REPO, JAX_PKG)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), root)


def _public_names(path):
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            yield node.name
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            yield node.name
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and not sub.name.startswith("_"):
                    yield f"{node.name}.{sub.name}"


def _port_module(rel):
    name = PORT_PKG + "." + rel[: -len(".py")].replace(os.sep, ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        return None


def _resolves(obj, dotted):
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _missing_names():
    missing = set()
    count = 0
    for rel in _jax_modules():
        mod = _port_module(rel)
        if mod is None:
            missing.add(rel)
            continue
        for name in _public_names(os.path.join(REPO, JAX_PKG, rel)):
            count += 1
            if not _resolves(mod, name):
                missing.add(f"{rel}:{name}")
    return missing, count


def test_every_jax_public_name_is_ported_or_listed():
    missing, count = _missing_names()
    assert count > 850
    assert sorted(missing) == sorted(NAME_DIFFERENCES)


@pytest.mark.parametrize("key", sorted(NAME_DIFFERENCES))
def test_each_listed_name_difference_has_a_reason(key):
    reason = NAME_DIFFERENCES[key]
    assert reason.startswith(_PREFIXES), reason
    if reason.startswith("renamed to `"):
        target = reason[len("renamed to `"):].split("`")[0]
        module, _, name = target.rpartition(".")
        while module and _port_module(module.replace(".", os.sep) + ".py") is None:
            module, _, head = module.rpartition(".")
            name = f"{head}.{name}"
        assert module and _resolves(_port_module(module.replace(".", os.sep) + ".py"), name), target


# ---------------------------------------------------------------------------
# (b) The JAX package's test modules
# ---------------------------------------------------------------------------

_BENCH = "bench-only: the JAX package's benchmark harness; the port has no benchmark yet (ROADMAP A18a)"

# JAX test module -> (port test files, a word of the behaviour found in one of
# them), or the reason it has none.
TEST_MODULES = {
    "test_async_oom.py": (("parity_async_oom", "capture_modes", "pack_split"), "ASYNC_FORK_HBM_LIMIT_BYTES"),
    "test_async_take.py": (("snapshot", "train_state", "capture_modes", "chaos", "faults"), "async_take"),
    "test_batcher.py": (("format", "kernels", "snapshot", "pack_split", "parity_units"), "batched/"),
    "test_broadcast_restore.py": (("read_serving", "parity_knobs", "parity_restore_index"), "BCAST_RESTORE"),
    "test_catalog.py": (("catalog", "parity_knobs"), "retain"),
    "test_chaos.py": (("chaos",), "FAULTS"),
    "test_cli.py": (("cli",), "__main__"),
    "test_collective_tracer.py": (("store",), "CollectiveDivergenceError"),
    "test_compression.py": (("compression",), "COMPRESSION"),
    "test_continuous_bench.py": _BENCH,
    "test_crash_explorer.py": (("crash_explorer",), "explore"),
    "test_d2h_lanes.py": (("capture_modes", "telemetry", "cuda", "parity_stall_decomposition"), "stage_d2h_s"),
    "test_engine.py": (("engine", "parity_engine"), "GraphExecutor"),
    "test_flatten.py": (("parity_surface", "format", "fuzz_roundtrip", "parity_units"), "FLATTEN_CASES"),
    "test_fleet.py": (("fleet",), "fleet-health"),
    "test_fuzz_roundtrip.py": (("fuzz_roundtrip",), "seed"),
    "test_gcs_multirank.py": (("gcs",), "gs://"),
    "test_gcs_storage_plugin.py": (("gcs",), "gs://"),
    "test_hash_compat.py": (("parity_hash_compat", "read_serving", "incremental"), "is_v2_record"),
    "test_hashing.py": (("parity_hash_compat",), "crc32_combine"),
    "test_health.py": (("parity_units", "fleet"), "detect_anomalies"),
    "test_incremental.py": (("incremental",), "base="),
    "test_io_preparer.py": (("parity_surface", "shard_geometry", "parity_units", "compression"), "chunk_row_ranges"),
    "test_knobs.py": (("capture_modes", "docs", "parity_knobs"), "override_"),
    "test_lazy_restore.py": (("read_serving", "restore_overlap", "compression"), "include="),
    "test_ledger.py": (("ledger",), "DEBUG_LEDGER"),
    "test_manifest.py": (("parity_surface", "format"), "get_manifest_for_rank"),
    "test_memoryview_stream.py": (("format",), "MemoryviewStream"),
    "test_moe.py": (("models",), "moe"),
    "test_multichip_bench.py": _BENCH,
    "test_multiprocess.py": (("sharded", "store", "abort_contract", "telemetry_artifacts"), "run_with_processes"),
    "test_native_io.py": (("native_io",), "O_DIRECT"),
    "test_partitioner.py": (("shard_geometry", "parity_units"), "partition_write"),
    "test_plan_cache.py": (("plan_cache",), "PLAN_CACHE"),
    "test_prepare_cache.py": (("plan_cache",), "prepare_cache"),
    "test_qos_bench.py": _BENCH,
    "test_read_cache.py": (("read_serving", "parity_hash_compat", "parity_reshard_overlap"), "READ_CACHE_DIR"),
    "test_recorder.py": (("telemetry",), "recorder"),
    "test_replication_glob.py": (("parity_surface", "sharded", "plan_cache"), "preflight"),
    "test_reshard_bench.py": _BENCH,
    "test_reshard_overlap.py": (("parity_reshard_overlap", "read_serving"), "origin_reads"),
    "test_restore_index.py": (("parity_restore_index",), "items_calls"),
    "test_restore_overlap.py": (("restore_overlap",), "RESTORE_OVERLAP"),
    "test_rss_profiler.py": (("parity_units",), "measure_rss_deltas"),
    "test_s3_storage_plugin.py": (("s3",), "s3://"),
    "test_scheduler.py": (("parity_scheduler", "stream_select", "parity_engine"), "execute_write_reqs"),
    "test_sequence_parallel.py": (("parity_sequence_parallel",), "Shard(2)"),
    "test_serialization.py": (("parity_surface", "format", "parity_units"), "array_from_bytes"),
    "test_serving_bench.py": _BENCH,
    "test_shard_geometry.py": (("shard_geometry",), "overlap"),
    "test_sharded_read_budget.py": (("parity_sharded_read_budget",), "memory_budget_bytes"),
    "test_sharded_resharding.py": (("sharded",), "Shard("),
    "test_snapshot.py": (("snapshot",), "read_object"),
    "test_staging_bench.py": _BENCH,
    "test_stall_decomposition.py": (("parity_stall_decomposition",), "LAST_TAKE_PHASES"),
    "test_static_analysis.py": (("static_analysis",), "get_passes"),
    "test_step_telemetry.py": (("telemetry_artifacts", "parity_units"), "steprecord"),
    "test_storage_plugin.py": (("parity_surface", "plugin_contract", "read_serving"), "url_to_storage_plugin"),
    "test_store.py": (("store",), "LinearBarrier"),
    "test_stream_select.py": (("stream_select",), "stream_select"),
    "test_swarm.py": (("read_serving", "parity_knobs", "parity_reshard_overlap"), "SWARM_RESTORE"),
    "test_telemetry.py": (("telemetry",), "spans"),
    "test_telemetry_artifacts.py": (("telemetry_artifacts",), "artifact"),
    "test_test_utils.py": (("test_utils",), "check_state_dict_eq"),
    "test_train_state.py": (("train_state",), "PyTreeStateful"),
    "test_verify.py": (("parity_verify", "snapshot"), "verify()"),
}


def _jax_test_modules():
    return sorted(
        f for f in os.listdir(os.path.join(REPO, "tests"))
        if f.startswith("test_") and f.endswith(".py") and not f.startswith("test_torch_")
    )


def test_every_jax_test_module_is_mapped_or_listed():
    assert _jax_test_modules() == sorted(TEST_MODULES)


@pytest.mark.parametrize("module", sorted(TEST_MODULES))
def test_each_mapping_names_port_tests_that_hold_it(module):
    entry = TEST_MODULES[module]
    if isinstance(entry, str):
        assert entry.startswith("bench-only: ") and "bench" in module
        return
    files, word = entry
    texts = []
    for short in files:
        path = os.path.join(REPO, "tests", f"test_torch_{short}.py")
        assert os.path.exists(path), path
        texts.append(open(path).read())
    assert any(word in text for text in texts), (module, word)
