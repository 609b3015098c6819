"""Pack ragged tokenized documents into fixed-length training windows.

The loader (`tpu_on_k8s_torch/data/loader.py`) serves fixed-size records —
what the static-shape training step wants — but real corpora are ragged
documents. Two standard packing strategies:

* ``"stream"`` (GPT-2 style): concatenate every document with an EOS
  separator into one token stream and slice it into windows. Zero
  padding waste; documents may straddle window boundaries (the causal LM
  objective tolerates the context bleed, and this is how most
  pretraining corpora are packed).
* ``"greedy"`` (no-split): first-fit documents whole into windows,
  EOS-separated, padding each window's tail with ``pad_id``. No
  cross-document bleed mid-window at the cost of padding waste; the
  returned mask weights real tokens for the loss.

Both are pure NumPy — run once at corpus-prep time, then
``write_records`` the result for the mmap'd loader.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np


def pack_stream(docs: Iterable[np.ndarray], seq_len: int,
                eos_id: int) -> np.ndarray:
    """[n, seq_len] windows sliced from the EOS-joined document stream;
    the ragged tail (< seq_len tokens) is dropped."""
    pieces = []
    for d in docs:
        d = np.asarray(d, np.int32).reshape(-1)
        pieces.append(d)
        pieces.append(np.asarray([eos_id], np.int32))
    if not pieces:
        return np.zeros((0, seq_len), np.int32)
    stream = np.concatenate(pieces)
    n = stream.size // seq_len
    return stream[:n * seq_len].reshape(n, seq_len).copy()


def pack_greedy(docs: Iterable[np.ndarray], seq_len: int, eos_id: int,
                pad_id: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """First-fit whole-document packing: ``(windows [n, seq_len],
    mask [n, seq_len])`` with 1 marking real (non-pad) tokens. Documents
    longer than ``seq_len - 1`` (a doc plus its EOS must fit) are
    rejected — split such docs upstream or use ``pack_stream``."""
    pad = eos_id if pad_id is None else pad_id
    eos = np.asarray([eos_id], np.int32)
    windows = []            # list of lists of doc arrays (joined at the end)
    remaining = []          # free capacity per window — the fit scan works
                            # on plain ints, not materialized token lists
    for d in docs:
        d = np.asarray(d, np.int32).reshape(-1)
        need = d.size + 1   # the doc and its EOS separator
        if need > seq_len:
            raise ValueError(
                f"document of {d.size} tokens cannot fit a {seq_len} "
                f"window whole; split it upstream or use pack_stream")
        for i, cap in enumerate(remaining):
            if need <= cap:
                windows[i] += [d, eos]
                remaining[i] = cap - need
                break
        else:
            windows.append([d, eos])
            remaining.append(seq_len - need)
    out = np.full((len(windows), seq_len), pad, np.int32)
    mask = np.zeros((len(windows), seq_len), np.int32)
    for i, parts in enumerate(windows):
        w = np.concatenate(parts)
        out[i, :w.size] = w
        mask[i, :w.size] = 1
    return out, mask
