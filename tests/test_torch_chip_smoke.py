"""``chip_smoke.py`` stops every process it starts: after a script that
starts what the smoke run starts (a forkserver that preloads torch, a
spawned process and the resource tracker, an orphaned grandchild) and
then calls ``chip_smoke._stop_processes``, no process of its session is
left once it exits."""

import os
import subprocess
import sys
import textwrap

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
