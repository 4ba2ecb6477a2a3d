"""The one generator of the benchmark's inputs: batches of dispersed
scenarios, read from a traffic mix file and a configuration's scenario.

Batch i's lanes come from one call of float64 normal draws of a
``torch.Generator`` on the run's device, seeded from the mix's
``pool_seed`` and i; each field the mix disperses takes its columns, in the
order of the scenario's fields:

    "add":   field + std * z            (a position, a velocity)
    "scale": field * (1 + std * z)      (a mass, as a fraction)

Fields the mix does not name keep the scenario's value on every lane.
Batch i holds those lanes in an order drawn from (``--seed``, i): the
dispersions set how many iterations a batch takes, so every seed asks for
the same batches of work, each in another order, and no two batches of a
window repeat a scenario. The batch is handed in the
configuration's dtype, the same tensors to the program and to the
reference.
"""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for stream ``index`` of ``seed``; any whole
    ``seed``, however large, gives a seed torch accepts."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def batch(config: dict, mix: dict, seed: int, index: int, device) -> dict:
    """Field name -> (B, ...) tensor of the configuration's dtype."""
    dtype = getattr(torch, config["solver"]["dtype"])
    B = mix["batch"]
    base = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
            for k, v in config["scenario"].items()}
    widths = {k: base[k].numel() for k in mix["dispersion"]}
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(mix["pool_seed"], index))
    z = torch.randn((B, sum(widths.values())), generator=gen,
                    dtype=torch.float64, device=device)
    gen.manual_seed(stream_seed(seed, index))
    z = z[torch.randperm(B, generator=gen, device=device)]
    out, col = {}, 0
    for k, v in base.items():
        lane = v.expand((B,) + v.shape)
        if k in mix["dispersion"]:
            d = mix["dispersion"][k]
            zk = z[:, col: col + widths[k]].reshape(lane.shape)
            col += widths[k]
            if d["kind"] == "add":
                lane = lane + d["std"] * zk
            elif d["kind"] == "scale":
                lane = lane * (1.0 + d["std"] * zk)
            else:
                raise ValueError(f"dispersion kind {d['kind']!r} of {k}")
        out[k] = lane.to(dtype).contiguous()
    missing = set(mix["dispersion"]) - set(base)
    if missing:
        raise KeyError(f"the mix disperses fields the scenario lacks: "
                       f"{sorted(missing)}")
    return out


def nominal(config: dict, device) -> dict:
    """The undispersed scenario as a batch of one lane."""
    dtype = getattr(torch, config["solver"]["dtype"])
    return {k: torch.as_tensor(v, dtype=dtype, device=device)[None]
            for k, v in config["scenario"].items()}
