#!/usr/bin/env python3
"""How far RWKV-6's float32 gradients lie from float64 through each form of
the wkv forward.

    python3 scripts/torch_wkv_gate_probe.py

The pass ``chip_smoke.py``'s ``rwkv_train_parity`` gates (RWKV-6 1.6B at
full width and depth, float32 compute with TF32 off, batch 2 x 1024 from
the seed, each layer recomputed): the float64 gradient, then the float32
gradient through four forwards, each parameter's leaves read against
float64 by relative L2 (``chip_smoke.rel_l2_leaves``):

* ``kernels``: the ops as the training path runs them (B8's chunked
  route, B9);
* ``plain``: the plain versions (the gate's reference path);
* ``plain, pair-form forward``: the plain path with the forward computed
  as in-chunk pairs from each chunk's entry state,
  y_t = (A_t r_t)^T S0 + sum_{s<t} (sum_i r_ti c(s,t)_i k_si) v_s + bonus,
  with A_t and c(s,t) products of w's (chunks of 16 tokens);
* ``plain, chunk-serial forward``: the plain path with the forward as the
  chunked route computes it (``wkv6_fwd_chunked_plain``: chunk-entry
  states, then each chunk stepped token by token).

Prints one JSON line per forward (the largest and mean reading, the worst
leaves, and how many leaves pass the gate ``chip_smoke.leaf_gates`` draws
from the plain path), then the card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def pair_form_fwd(r, k, v, w, u, s0, chunk: int = 16, **launch):
    """The in-chunk pair form of the wkv forward in plain PyTorch."""
    b, t, h, hd = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t

    def chunks(x, fill):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.view(b, n, chunk, h, hd).permute(0, 3, 1, 2, 4)

    rr, kk, vv = (chunks(x, 0.0) for x in (r, k, v))
    ww = chunks(w, 1.0)
    ones = torch.ones_like(ww[..., :1, :])
    pre = torch.cumprod(torch.cat([ones, ww[..., :-1, :]], -2), -2)
    suf = torch.cumprod(torch.cat([ones, ww.flip(-2)[..., :-1, :]], -2),
                        -2).flip(-2)
    whole = pre[..., -1, :] * ww[..., -1, :]
    local = torch.einsum("bhnti,bhntj->bhnij", suf * kk, vv)
    s, entry = s0, []
    for c in range(n):
        entry.append(s)
        s = whole[:, :, c, :, None] * s + local[:, :, c]
    y = torch.einsum("bhnti,bhnij->bhntj", pre * rr, torch.stack(entry, 2))
    y = y + (rr * u[None, :, None, None, :] * kk).sum(-1, keepdim=True) * vv
    coef = torch.ones_like(ww)
    for d in range(1, chunk):
        cd = coef[..., :chunk - d, :]
        q = (rr[..., d:, :] * cd * kk[..., :chunk - d, :]).sum(-1,
                                                               keepdim=True)
        y[..., d:, :] += q * vv[..., :chunk - d, :]
        coef = cd[..., :chunk - d - 1, :] * ww[..., d:chunk - 1, :]
    return y.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, hd)[:, :t], s


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke.ssm_train_cfg(smoke.RWKV_ARCH, "float32")
    model = build_model(cfg, seed=0)
    batch = smoke.train_batch(cfg, 0, batch=smoke.SSM_PARITY_BATCH,
                              seq=smoke.SSM_PARITY_SEQ[smoke.RWKV_ARCH])
    _, truth = smoke.float64_grads(model, batch)
    torch.cuda.empty_cache()

    def plain_with(fwd):
        return [p for p in smoke.train_plain_patches()
                if p.attribute != "wkv6_fwd"] + [
            mock.patch.object(wkv_ops, "wkv6_fwd", fwd)]

    def chunk_serial_fwd(r, k, v, w, u, s0, **launch):
        return wkk.wkv6_fwd_chunked_plain(r, k, v, w, u, s0,
                                          chunk=launch.get("chunk", 64))

    forwards = {"kernels": [], "plain": smoke.train_plain_patches(),
                "plain, pair-form forward": plain_with(pair_form_fwd),
                "plain, chunk-serial forward": plain_with(chunk_serial_fwd)}
    readings = {}
    for name, patches in forwards.items():
        _, grads = smoke.ssm_grads(model, batch, patches)
        readings[name] = smoke.rel_l2_leaves(grads, truth)
        del grads
        torch.cuda.empty_cache()
    gates = smoke.leaf_gates(readings["plain"])
    for name, rel in readings.items():
        print(json.dumps({"forward": name, **smoke.summary(rel),
                          "leaves": len(rel),
                          "leaves_over_gate": len(smoke.over_gate(rel, gates))}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
