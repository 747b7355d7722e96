"""What every driver shares: seeds derived from the run's seed, weights made
on the device from a seed, the device's description, and the guard that
nothing of JAX was loaded."""
from __future__ import annotations

import hashlib
import math
import subprocess
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_ode_metasolver_tpu")


def sub_seed(seed: int, tag: str) -> int:
    """A seed below 2**62 for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def make_weights(spec, seed: int, device, members: Optional[int] = None
                 ) -> Dict[str, "torch.Tensor"]:
    """Float32 weights for a reference's ``param_spec``, made on ``device``
    from ``seed`` in one uniform draw: U(-bound, bound) for a numeric
    bound, ones or zeros where the spec says so; ``members`` stacks that
    many independent sets along a leading axis."""
    import torch

    lead = () if members is None else (members,)
    count = members or 1
    sizes = [math.prod(shape) * count for _, shape, init in spec
             if not isinstance(init, str)]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    r = torch.rand(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        if isinstance(init, str):
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full(lead + tuple(shape), fill, device=device)
            continue
        n = math.prod(shape) * count
        out[name] = ((r[off:off + n] * 2.0 - 1.0) * init).reshape(
            lead + tuple(shape))
        off += n
    return out


def loaded_forbidden() -> List[str]:
    """Modules of JAX or the JAX package in ``sys.modules``, compared by
    their whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
