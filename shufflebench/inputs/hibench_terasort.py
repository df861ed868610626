"""HiBench TeraSort records, made on the device from the seed.

Rank r's records are two streams of the run's seed: the int64 keys
(stream (r, 0)) and the [n, W] int32 payload rows (stream (r, 1)), each
one call of ``random_`` over the whole tensor, uniform over the dtype's
whole range.  The plain reference makes any rank's records again from
the same seed without the program.  Plain torch only.
"""

from __future__ import annotations

from shufflebench.common import generator

KEYS, PAYLOAD = 0, 1


def records(config) -> int:
    return int(config["records_per_card"])


def make_keys(config, seed: int, rank: int, device):
    import torch

    g = generator(device, seed, rank, KEYS)
    keys = torch.empty(records(config), dtype=torch.int64, device=device)
    return keys.random_(torch.iinfo(torch.int64).min, None, generator=g)


def make_payload(config, seed: int, rank: int, device):
    import torch

    g = generator(device, seed, rank, PAYLOAD)
    rows = torch.empty((records(config), int(config["payload_words_int32"])),
                       dtype=torch.int32, device=device)
    return rows.random_(torch.iinfo(torch.int32).min, None, generator=g)
