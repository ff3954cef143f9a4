"""``chip_smoke.py`` stops every process it starts: after a script that
starts what the smoke run starts (a forkserver that preloads torch, a
spawned process and the resource tracker, an orphaned grandchild) and
then calls ``chip_smoke._stop_processes``, no process of its session is
left once it exits."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import multiprocessing, subprocess, sys, time
    sys.path.insert(0, {repo!r})
    import chip_smoke


    def noop():
        pass


    if __name__ == "__main__":
        chip_smoke._become_subreaper()
        fork = multiprocessing.get_context("forkserver")
        fork.set_forkserver_preload(["torch"])
        for ctx in (fork, multiprocessing.get_context("spawn")):
            proc = ctx.Process(target=noop)
            proc.start()
            proc.join()
            assert proc.exitcode == 0, proc.exitcode
        # Its parent ends at once: the sleep is an orphan of this process.
        subprocess.run(["sh", "-c", "sleep 120 >/dev/null 2>&1 &"], check=True)
        left = [pid for pid, state in chip_smoke._descendants(chip_smoke.os.getpid()) if state != "Z"]
        assert len(left) >= 3, left  # the forkserver, the tracker, the sleep
        t0 = time.monotonic()
        signalled = chip_smoke._stop_processes()
        print({{"left": left, "signalled": signalled, "stop_s": time.monotonic() - t0}}, flush=True)
        assert chip_smoke._descendants(chip_smoke.os.getpid()) == []
        assert chip_smoke._stop_processes() == []
    """
)


def _session_members(sid):
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid:
            out.append((int(entry), stat))
    return out


def test_no_process_outlives_the_script(tmp_path):
    script = tmp_path / "starts_processes.py"
    script.write_text(_SCRIPT.format(repo=REPO))
    proc = subprocess.Popen(
        [sys.executable, str(script)], cwd=str(tmp_path), start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        left = _session_members(proc.pid)
        for pid, _ in left:
            os.kill(pid, 9)
    assert proc.returncode == 0, err[-3000:]
    assert left == [], left
    # The orphaned sleep needs the fallback signals; the forkserver and the
    # tracker are stopped through their own handles.
    assert "'signalled': [" in out and "'signalled': []" not in out, out


def _phase12_result(**overrides):
    out = {
        "layers": 4, "state_bytes": 1, "live_reserved_bytes": 1, "cap_bytes": 2,
        "peak_reserved_under_cap_bytes": 1, "slabs": {"sync": 4, "donate": 4, "uncapped": 4},
        "warnings": {"sync": 4, "donate": 4},
        "launches_capped": {"pack_slab": 40, "fork_copy": 0, "copy_blocks": 0},
        "launches_uncapped": {"pack_slab": 4, "fork_copy": 0, "copy_blocks": 0},
        "slab_members": 32, "member_bytes_compared": 1,
    }
    out.update(overrides)
    return out


def test_phase12_runs_in_a_child_and_leaves_the_parent_as_it_was(tmp_path, monkeypatch):
    """Phase 12 caps the allocator only in a child process: the parent
    starts ``python -c`` on ``phase12_child`` and reads its result, and
    never calls the cap itself; the child's K1 launches, under the cap and
    after it, are what the parent counts."""
    import torch

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    calls = []

    def fake_run(cmd, cwd=None, **kwargs):
        calls.append((cmd, cwd))
        with open(cmd[-1], "w") as f:
            json.dump(_phase12_result(), f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    def no_cap(*args, **kwargs):
        raise AssertionError("the parent capped its own allocator")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction", no_cap)
    launches, out = chip_smoke.phase12(0, str(tmp_path), "card")
    (cmd, cwd), = calls
    assert cmd[:2] == [sys.executable, "-c"] and "phase12_child" in cmd[2] and cwd == REPO
    assert launches == {"pack_slab": 44, "fork_copy": 0, "copy_blocks": 0}
    assert "child_s" in out

    def failing_run(cmd, cwd=None, **kwargs):
        with open(cmd[-1], "w") as f:
            json.dump({"error": "Traceback ...\nAssertionError: phase12: the capped sync take did not pack every slab in groups"}, f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", failing_run)
    try:
        chip_smoke.phase12(0, str(tmp_path / "again"), "card")
        raise AssertionError("a failed child passed")
    except AssertionError as e:
        assert "did not pack every slab in groups" in str(e)


def test_phase10_d_expects_the_wrapped_rot_error(tmp_path, monkeypatch):
    """Phase 10 (d)'s check takes the world-1 restore's
    ``CheckpointAbortedError`` (rank 0, ``restore.read``) whose cause names
    the rotten object, and refuses the root error raised bare."""
    import torch

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    import torchsnapshot_tpu_torch as tts

    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.arange(64.0))})
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "all")
    monkeypatch.setenv("TSS_TORCH_FAULTS", "op=read,after=0,kind=corrupt,path=0/m/x")
    try:
        tts.Snapshot(path).restore({"m": tts.StateDict(x=torch.zeros(64))}, device="cpu")
        raise AssertionError("a rotten object restored")
    except tts.CheckpointAbortedError as e:
        assert "0/m/x" in chip_smoke._rot_abort(e, "0/m/x")
        try:
            chip_smoke._rot_abort(e.__cause__, "0/m/x")
            raise RuntimeError("a bare ReadVerificationError passed")
        except AssertionError:
            pass


def test_script_needs_cuda_and_prints_no_result(tmp_path):
    """On a host without CUDA the script exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the host has CUDA")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_the_per_phase_launch_line_sums_each_phases_counts(monkeypatch):
    """One line gives each phase's K1, K2 and K3 launches, summed however
    the phase nests its counts: a counts dict, labels of counts, ranks'
    lists, partial counts."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    per_phase = {
        "phase2": {"sync_take": {"pack_slab": 11, "fork_copy": 0, "copy_blocks": 0},
                   "async_take": {"pack_slab": 11, "fork_copy": 1, "copy_blocks": 0}},
        "phase3": [{"restore": {"pack_slab": 0, "fork_copy": 0, "copy_blocks": 50}},
                   {"restore": {"pack_slab": 0, "fork_copy": 0, "copy_blocks": 50}}],
        "phase4": {"pack_slab": 31, "fork_copy": 1, "copy_blocks": 0},
        "phase6": {},
        "phase13": {"phase13a_sync_take": {"pack_slab": 4, "fork_copy": 0, "copy_blocks": 0},
                    "phase13b_embedding_rank0": {"copy_blocks": 2}},
    }
    line = chip_smoke.phase_launch_line(per_phase, "NVIDIA H100 80GB HBM3, 700.00 W")
    head = "launches per phase [K1 pack_slab, K2 fork_copy, K3 copy_blocks] on NVIDIA H100 80GB HBM3, 700.00 W: "
    assert line.startswith(head) and "\n" not in line
    assert json.loads(line[len(head):]) == {
        "phase2": [22, 1, 0], "phase3": [0, 0, 100], "phase4": [31, 1, 0], "phase6": [0, 0, 0], "phase13": [4, 0, 2],
    }


def test_phase14_state_and_its_rank4_rectangle(monkeypatch):
    """Phase 14 at its width: per layer K and V ``[8, 32, 512, 128]`` bf16
    and the residuals ``[8, 512, 4096]`` fp32, 536,870,912 bytes each in
    all over 8 layers; its sequence-half reshard rectangles collapse to
    two dims (one K3 descriptor), the hold's half-heads, half-head_dim
    block to four (one descriptor, three dims outside its row)."""
    import torch

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from torchsnapshot_tpu_torch import kernels

    layout = chip_smoke.kv_layout(8)
    nbytes = {}
    for name, shape, dtype, placement in layout:
        kind = name.split("/")[1]
        nbytes[kind] = nbytes.get(kind, 0) + int(torch.Size(shape).numel()) * dtype.itemsize
        assert placement.dim == (1 if kind == "resid" else 2)
    assert nbytes == {"k": 268435456, "v": 268435456, "resid": 536870912}
    shard = torch.zeros(8, 32, 256, 128, dtype=torch.bfloat16)
    whole = torch.zeros(8, 32, 512, 128, dtype=torch.bfloat16)
    target = whole[:4]  # a Shard(0) target's block of batch rows
    reshard = (shard[:4], target[:, :, 256:, :])
    assert chip_smoke.collapsed_rank(*reshard) == 2 and len(kernels.rect_table([reshard])[0]) == 1
    hold = (shard[:, :16, :, :64], whole[:, 16:, 256:, 64:])
    assert chip_smoke.collapsed_rank(*hold) == 4 and len(kernels.rect_table([hold])[0]) == 1


def test_k3_sweep_shapes_keep_their_ranks(monkeypatch):
    """K3's sweep on the card runs the shapes ``PERF.md`` names: (c) two
    dims of 64 KiB rows, (d) and (e) four dims of 128- and 256-byte rows,
    (f) five dims, (g) grain 2 at odd element offsets; each one
    descriptor. (b), one rank's 2 GB reshard, is left to the card."""
    import torch

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from torchsnapshot_tpu_torch import kernels

    monkeypatch.setattr(chip_smoke, "reshard_rectangles", lambda device, gb, gen: ([], []))
    want = {
        "rectangle": (2, 16384, 16), "reshard_restore": None, "kv_shard0": (2, 65536, 16),
        "rank4_hold": (4, 128, 16), "permuted_gather": (4, 256, 16), "permuted_5d": (5, 256, 16),
        "grain2": (2, 2048, 2),
    }
    got = {}
    for label, pairs in chip_smoke.k3_sweep_shapes("cpu", 4.0, torch.Generator().manual_seed(0)):
        if not pairs:
            got[label] = None
            continue
        (src, dst), = pairs
        table, total = kernels.rect_table(pairs)
        assert len(table) == 1 and total == src.numel() * src.element_size()
        got[label] = (chip_smoke.collapsed_rank(src, dst), int(table["row_bytes"][0]), int(table["grain"][0]))
    assert got == want


def test_cold_copies_keep_each_sweep_shape_as_one_descriptor(monkeypatch):
    """The cold column's fresh copies of a sweep shape keep its strides,
    its address modulo 16 and so its table (rows, dims, grain), and copy
    the same elements as the original views."""
    import torch

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from torchsnapshot_tpu_torch import kernels

    monkeypatch.setattr(chip_smoke, "reshard_rectangles", lambda device, gb, gen: ([], []))
    fields = ("rows", "row_bytes", "ndim", "grain", "size", "src_stride", "dst_stride", "nbytes")
    for label, pairs in chip_smoke.k3_sweep_shapes("cpu", 4.0, torch.Generator().manual_seed(0)):
        if not pairs or label == "permuted_5d":  # 5-D: 256 MiB read and written, past 4 x L2
            continue
        copies = [(chip_smoke._rebased(x), chip_smoke._rebased(d)) for x, d in pairs]
        for (x, d), (x2, d2) in zip(pairs, copies):
            assert (x2.shape, x2.stride(), d2.shape, d2.stride()) == (x.shape, x.stride(), d.shape, d.stride())
            assert (x2.data_ptr() % 16, d2.data_ptr() % 16) == (x.data_ptr() % 16, d.data_ptr() % 16)
            x2.copy_(x)
        want, _ = kernels.rect_table(pairs)
        got, _ = kernels.rect_table(copies)
        for f in fields:
            assert (got[f] == want[f]).all(), (label, f)
        kernels.copy_blocks(copies)
        for (x, _), (_, d2) in zip(pairs, copies):
            assert torch.equal(d2, x), label
