"""Plain reference of HiBench TeraSort, and its control.

The answer of a world of D ranks is the stable sort, by the int64 key,
of every rank's records concatenated in rank order, each payload row
following its key.  Rank r's valid rows are the slice of that answer
that starts after the valid rows of ranks 0 .. r-1; its padding keys
are int64 max, and on one card its padding payload rows are zero (the
model's contract; across cards they are left unspecified).

The records come again from the seed (``inputs/hibench_terasort.py``),
never from the program.  Plain torch; imports nothing of the program.

Numbers compared, each with limit 0 (the comparison is exact):

- ``rows_wrong``: valid rows whose key or payload differ from the
  answer, plus rows a rank reports past the end of the answer;
- ``count_gap``: |valid rows over all ranks - records over all ranks|;
- ``pad_wrong``: padding rows that are not the padding.

The control (``control``) is this reference sorting by the key's high
32 bits only: the int32-key precision below the int64 key the
configuration states, which the JAX package's 4-byte-key bench uses.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from shufflebench.common import module

LIMITS = {"rows_wrong": 0, "count_gap": 0, "pad_wrong": 0}
BLOCK = 1 << 22  # rows compared at once


def _inputs():
    return module("inputs", "hibench_terasort")


def n_valid(output) -> int:
    return int(output[2].reshape(-1)[0])


def _order(config, seed: int, world: int, device, control: bool):
    """Every rank's keys in rank order and the answer's permutation."""
    import torch

    keys = torch.cat([_inputs().make_keys(config, seed, r, device)
                      for r in range(world)])
    sort_keys = keys >> 32 if control else keys
    return keys, torch.sort(sort_keys, stable=True).indices


def _slice(config, world: int, offset: int, nv: int):
    total = world * _inputs().records(config)
    lo = min(max(offset, 0), total)
    return lo, min(lo + max(nv, 0), total)


def _payload_rows(config, seed: int, world: int, perm, fill, device):
    """``fill(i, idx, rows)`` for each block of ``perm`` (global row
    numbers): ``rows`` are the payload rows of ``perm[i:][idx]``, made
    again one source rank at a time."""
    n = _inputs().records(config)
    for s in range(world):
        pay = _inputs().make_payload(config, seed, s, device)
        for i in range(0, perm.shape[0], BLOCK):
            src = perm[i:i + BLOCK]
            idx = ((src // n) == s).nonzero().reshape(-1)
            if idx.numel():
                fill(i, idx, pay.index_select(0, src[idx] % n))
        del pay


def judge(config, seed: int, world: int, rank: int, output, offset: int,
          device) -> Dict[str, int]:
    """Readings of one rank's output ``(keys, payload, n_valid, ...)``;
    ``offset`` is the valid rows of the ranks before it."""
    import torch

    out_k, out_p = output[0], output[1]
    nv = n_valid(output)
    words = int(config["payload_words_int32"])
    keys, perm = _order(config, seed, world, device, control=False)
    lo, hi = _slice(config, world, offset, nv)
    count = min(hi - lo, out_k.shape[0])
    perm = perm[lo:lo + count]
    bad = out_k[:count] != keys[perm]
    del keys
    if out_p.dim() != 2 or out_p.shape[1] != words:
        bad[:] = True
    else:
        def fill(i, idx, rows):
            got = out_p[i:i + BLOCK].index_select(0, idx)
            bad[i + idx] |= (got != rows).any(dim=1)

        _payload_rows(config, seed, world, perm, fill, device)
    rows_wrong = int(bad.sum()) + (nv - count)
    pad = out_k[max(nv, 0):]
    pad_wrong = int((pad != torch.iinfo(torch.int64).max).sum())
    if world == 1 and out_p.dim() == 2:
        for i in range(max(nv, 0), out_p.shape[0], BLOCK):
            pad_wrong += int((out_p[i:i + BLOCK] != 0).any(dim=1).sum())
    return {"rows_wrong": rows_wrong, "pad_wrong": pad_wrong, "n_valid": nv}


def combine(readings: Sequence[Dict[str, int]], config,
            world: int) -> Dict[str, int]:
    """One output's numbers from every rank's readings (rank order)."""
    total = world * _inputs().records(config)
    return {
        "rows_wrong": sum(r["rows_wrong"] for r in readings),
        "count_gap": abs(sum(r["n_valid"] for r in readings) - total),
        "pad_wrong": sum(r["pad_wrong"] for r in readings),
    }


def control(config, seed: int, world: int, rank: int, offset: int, nv: int,
            rows_out: int, device) -> List[object]:
    """The control's output for rank ``rank``, in the program's output
    layout: the same slice of the answer as the program's, sorted by
    the key's high 32 bits."""
    import torch

    words = int(config["payload_words_int32"])
    keys, perm = _order(config, seed, world, device, control=True)
    lo, hi = _slice(config, world, offset, nv)
    perm = perm[lo:hi]
    out_k = torch.full((rows_out,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=device)
    out_k[:perm.shape[0]] = keys[perm]
    del keys
    out_p = torch.zeros((rows_out, words), dtype=torch.int32, device=device)

    def fill(i, idx, rows):
        out_p[i + idx] = rows

    _payload_rows(config, seed, world, perm, fill, device)
    n_out = torch.tensor([perm.shape[0]], dtype=torch.int32, device=device)
    return [out_k, out_p, n_out]
