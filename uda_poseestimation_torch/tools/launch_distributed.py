"""Start N local ranks of a port trainer as one data-parallel run.

The counterpart of ``tools/launch_distributed.py``, for the ``--dist-*``
surface of the port's trainers (``parallel/distributed.py``): it appends
``--dist-coordinator``, ``--dist-num-processes`` and ``--dist-process-id`` to
the given command for ranks 0..N-1, streams rank 0's output through,
prefixes the other ranks' lines with ``[rank k]``, stops the others when one
fails and exits with the first non-zero code. A CUDA rank takes GPU
``rank % device_count``; with ``--device cpu`` the ranks join over gloo.

    python -m uda_poseestimation_torch.tools.launch_distributed -n 2 -- \\
        python -m uda_poseestimation_torch.train_human <trainer flags...>

``--coordinator`` gives the rendezvous (``host:port``, or a ``file://`` URL
of a file that does not exist yet); by default a free localhost port.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import threading
import time
from typing import Optional


def free_port() -> int:
    """A free localhost TCP port (the default coordinator address). The
    launcher imports no torch, so that its ranks start sooner."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(num_processes: int, command: list, coordinator: Optional[str] = None) -> int:
    """Run ``command`` as ranks 0..N-1 and wait for them; returns the first
    non-zero exit code of a rank that failed by itself (0 when all
    succeed)."""
    if not command:
        raise ValueError("empty command")
    coordinator = coordinator or f"localhost:{free_port()}"
    flags = ["--dist-coordinator", coordinator, "--dist-num-processes", str(num_processes)]
    procs = []
    try:
        for rank in range(num_processes):
            procs.append(subprocess.Popen(
                list(command) + flags + ["--dist-process-id", str(rank)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    except Exception:
        for p in procs:  # no rank may wait at the rendezvous for one never started
            p.kill()
        raise

    def pump(rank, proc):
        prefix = "" if rank == 0 else f"[rank {rank}] "
        for line in proc.stdout:
            sys.stdout.write(prefix + line)
            sys.stdout.flush()

    threads = [threading.Thread(target=pump, args=(rank, p), daemon=True)
               for rank, p in enumerate(procs)]
    for t in threads:
        t.start()
    rcs = [None] * num_processes
    try:
        while any(rc is None for rc in rcs):
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                # the others would wait in a collective until its timeout
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=10)
    # a rank's own failure before the signals of the ranks stopped after it
    return next((rc for rc in rcs if rc and rc > 0), next((rc for rc in rcs if rc), 0))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Start N local ranks of a --dist-* trainer of the port")
    parser.add_argument("-n", "--num-processes", type=int, required=True)
    parser.add_argument("--coordinator", default=None,
                        help="host:port or file:// URL of the rendezvous "
                             "(default: a free localhost port)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="trainer command (after --)")
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no trainer command given (end the launcher's flags with --)")
    return launch(args.num_processes, command, coordinator=args.coordinator)


if __name__ == "__main__":
    sys.exit(main())
