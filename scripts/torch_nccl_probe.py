#!/usr/bin/env python3
"""What NCCL does when two processes share one GPU.

    python3 scripts/torch_nccl_probe.py

NCCL puts one rank on one GPU, so ``multihost.check_backend`` refuses
``backend="nccl"`` when processes outnumber the cards, and the
multi-process runtime shares a card over gloo. This script asks NCCL
itself, deliberately past that refusal: two child processes join an NCCL
group on ``cuda:0`` (``torch.distributed.init_process_group`` directly)
and all-reduce one CUDA tensor. It prints each child's exit code and the
end of its output, or that it hung (each child is killed after
``TIMEOUT_S``). Exits 0 once both children ended or were killed; needs a
GPU.
"""

import os
import socket
import subprocess
import sys
import time

TIMEOUT_S = 90

CHILD = r"""
import datetime, sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
t = torch.full((4,), float(rank + 1), device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print("all_reduce:", t.tolist(), flush=True)
dist.destroy_process_group()
"""


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs a GPU")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {torch.cuda.device_count()} GPU(s): "
          f"{torch.cuda.get_device_name(0)}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NCCL_DEBUG": "WARN"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for r, p in enumerate(procs):
        left = max(1.0, TIMEOUT_S - (time.perf_counter() - t0))
        try:
            out, _ = p.communicate(timeout=left)
            print(f"--- rank {r}: exit {p.returncode} after {time.perf_counter() - t0:.1f} s")
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            print(f"--- rank {r}: hung; killed after {time.perf_counter() - t0:.1f} s")
        print("\n".join(out.strip().splitlines()[-25:]))


if __name__ == "__main__":
    main()
