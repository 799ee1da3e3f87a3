"""Rendering over a ``torch.distributed`` process group, one process a
device: ``bpt_tpu.parallel.multiprocess`` in torch's idiom.

* ``init_multiprocess(...)`` joins this process to the group (its rank's
  device: a card, or the CPU).
* ``render_multiprocess(...)`` renders the pixel shard ``render_distributed``
  would give device ``rank`` and gathers the shards on every rank with
  ``dist.all_gather``, once, at the end.
* ``launch_local(...)`` / ``python -m bpt_tpu_torch.parallel.launch`` start
  N workers on this machine (a torchrun analog); on a cluster, start one
  worker a host with a shared ``--coordinator``.

The image equals the one-process render to the bit at any process count:
every draw is keyed by the absolute id pix*spp + s.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from bpt_tpu_torch.models.render import counts_to_stats, render_part
from bpt_tpu_torch.parallel.mesh import shard_range, shard_route

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multiprocess(process_id: int, num_processes: int,
                      coordinator: str = "localhost:29500", device: str = "cuda",
                      backend: Optional[str] = None) -> torch.device:
    """Join the process group as rank ``process_id`` of ``num_processes``
    (``dist.init_process_group`` over ``tcp://<coordinator>``) and return
    the rank's device: ``cuda:{process_id % cards}`` or the CPU.

    ``backend`` defaults to nccl on the card and gloo on the CPU.  nccl
    needs a card a rank and raises when there are more ranks than cards;
    gloo with CUDA ranks (several ranks on one card, the gather through the
    host) is taken only when asked for by name.  A CUDA rank on a host
    without a card raises."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multiprocess: device='cuda' but CUDA is not available")
        cards = torch.cuda.device_count()
        backend = backend or "nccl"
        if backend == "nccl" and num_processes > cards:
            raise RuntimeError(f"init_multiprocess: nccl needs a card a rank: "
                               f"{num_processes} ranks, {cards} card(s); pass "
                               f"backend='gloo' to share cards")
        dev = torch.device("cuda", process_id % cards)
        torch.cuda.set_device(dev)
    elif device == "cpu":
        backend = backend or "gloo"
        if backend == "nccl":
            raise ValueError("init_multiprocess: nccl needs device='cuda'")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"init_multiprocess: device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=process_id,
                            world_size=num_processes)
    return dev


def render_multiprocess(scene, cfg, seed: int = 0, integrator: Optional[str] = None,
                        fast: str = "auto"):
    """The pixel-sharded render over the process group: rank r renders the
    shard ``render_distributed`` gives device r (the scene on the rank's
    device), the shards, padded to one size, are joined with
    ``dist.all_gather`` (CPU tensors under gloo, the rank's card under
    nccl) and the counters summed with ``dist.all_reduce``.  Every rank
    calls it.

    Returns, on every rank, (framebuffer sum [H, W, 3] numpy, spp_eff,
    RenderStats)."""
    if not dist.is_initialized():
        raise RuntimeError("render_multiprocess: call init_multiprocess first")
    integrator = integrator or cfg.integrator
    rank, world = dist.get_rank(), dist.get_world_size()
    route = shard_route(scene, cfg, integrator, fast)
    W, H = cfg.image_width, cfg.image_height
    npix = W * H
    p0, p1 = shard_range(npix, world, rank)
    t0 = time.monotonic()
    part, counts = render_part(scene, cfg, seed, integrator, route, p0, p1)
    comm = torch.device("cpu") if dist.get_backend() == "gloo" else scene.device
    m = -(-npix // world)
    shard = torch.zeros((m, 3), dtype=scene.dtype, device=comm)
    shard[:p1 - p0] = part.to(comm)
    shards = [torch.empty_like(shard) for _ in range(world)]
    dist.all_gather(shards, shard)
    counts = counts.to(comm)
    dist.all_reduce(counts)
    fb = torch.cat(shards)[:npix].cpu().numpy().reshape(H, W, 3)
    return fb, cfg.sqrt_spp ** 2, counts_to_stats(counts, scene, time.monotonic() - t0)


def launch_local(num_processes: int, worker_args: Sequence[str], device: str = "cuda",
                 backend: Optional[str] = None, timeout: float = 600.0) -> list[str]:
    """Start ``num_processes`` workers on this machine and wait for them:

        python -m bpt_tpu_torch.parallel.worker --process-id I \\
            --num-processes N --coordinator localhost:PORT --device D \\
            [--backend B] <worker_args...>

    With ``device="cuda"`` the kernel library is built here first, so that
    the workers do not each run nvcc.  Returns each worker's output
    (stdout and stderr).  A worker that exits non-zero stops the others and
    raises RuntimeError with its output's end; at ``timeout`` seconds every
    worker still running is killed.  ``free_port`` closes its probe socket
    before the coordinator binds the port, so another process can take it
    in between: a failed bind is retried on a fresh port, three times in
    all."""
    if device == "cuda":
        from bpt_tpu_torch.ops.kernels import build

        build.build()
    for attempt in range(3):
        try:
            return _launch_local_once(num_processes, worker_args, device, backend, timeout)
        except RuntimeError as e:
            msg = str(e).lower()
            if attempt == 2 or ("bind" not in msg and "address already in use" not in msg):
                raise


def _launch_local_once(num_processes, worker_args, device, backend, timeout):
    port = free_port()
    logs = [tempfile.TemporaryFile() for _ in range(num_processes)]
    procs = []
    try:
        for i, log in enumerate(logs):
            cmd = [sys.executable, "-m", "bpt_tpu_torch.parallel.worker",
                   "--process-id", str(i), "--num-processes", str(num_processes),
                   "--coordinator", f"localhost:{port}", "--device", device,
                   *(["--backend", backend] if backend else []), *worker_args]
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            fail = next(((i, rc) for i, rc in enumerate(codes) if rc not in (None, 0)), None)
            if fail or None not in codes:
                break
            if time.monotonic() > deadline:
                fail = codes.index(None), f"-9 (killed at the {timeout:g} s timeout)"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    if fail is not None:
        i, rc = fail
        raise RuntimeError(f"worker {i} exited {rc}:\n{outs[i][-4000:]}")
    return outs
