"""Bank rotation for spec sets larger than the card (counterpart:
``challenge_tpu/data/streaming.py``; the ``--stream_chunks N --chunk_steps
K`` flags).

:func:`build_streaming_banks` shuffles each source list once with
``np.random.default_rng(seed)``, in JAX's order (backgrounds, then the
voices with their labels, then the noises), and deals it round-robin into
``n_chunks`` host banks built by ``specset.build_bank`` on the CPU. Every
chunk has the same tensor shapes, item counts and ``contig_exact_frames``
(the minimum over the chunks), so one fused step, and one CUDA graph,
serves all of them.

:class:`StreamingBanks` rotates the chunks through the card with JAX's
clock: the cursor advances every ``chunk_steps`` dispatches, and is a pure
function of the dispatch count, so a restored optimizer step puts it where
the uninterrupted run had it (:meth:`StreamingBanks.restore_cursor`). The
card holds two chunks: the *slot*, the one ``Banks`` that every dispatch
reads, at fixed addresses, and the *staged* copy of the next chunk. The
staged copy is uploaded from pinned host memory on a side stream while the
slot's chunk trains; at a swap the compute stream waits for that upload
and copies the staged chunk into the slot, device to device, behind every
step it has queued. The next upload waits for that copy, so no upload
overwrites memory that a queued step or copy still reads. A captured
graph keeps reading the slot, so rotation needs no new capture.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from challenge_tpu_torch.data.mixture import Banks
from challenge_tpu_torch.data.specset import SpecBank, build_bank, remap_labels
from challenge_tpu_torch.device import resolve_device


def _deal(items: Sequence, perm: np.ndarray, n_chunks: int) -> List[list]:
    """Round-robin the permuted items into ``n_chunks`` lists, every chunk
    non-empty (a short list wraps: item ``perm[i % n]`` for i in
    range(n_chunks)) and padded cyclically to a common count."""
    n = len(items)
    order = [int(perm[i % n]) for i in range(max(n, n_chunks))]
    chunks = [order[c::n_chunks] for c in range(n_chunks)]
    per = max(len(c) for c in chunks)
    return [[items[c[i % len(c)]] for i in range(per)] for c in chunks]


def _pad_flat_rows(bank: SpecBank, t_flat: int) -> SpecBank:
    """Zero-extend the flat layout's row axis to ``t_flat``: the rows only
    make the chunks' shapes equal, no draw reads them."""
    flat = bank.flat
    if flat.shape[1] == t_flat:
        return bank
    pad = flat.new_zeros((flat.shape[0], t_flat - flat.shape[1],
                          flat.shape[2]))
    return dataclasses.replace(bank, flat=torch.cat([flat, pad], 1))


def map_banks(banks: Banks, fn) -> Banks:
    """``banks`` with ``fn`` applied to each of its tensors."""
    def bank(b):
        if b is None:
            return None
        return dataclasses.replace(
            b, flat=fn(b.flat), lens=fn(b.lens), pos_mask=fn(b.pos_mask),
            flat_scale=None if b.flat_scale is None else fn(b.flat_scale))
    return Banks(bank(banks.backgrounds), bank(banks.voices),
                 fn(banks.voice_labels), bank(banks.noises))


def bank_tensors(banks: Banks) -> List[torch.Tensor]:
    """Every tensor of ``banks``, in a fixed order."""
    out = []
    map_banks(banks, out.append)
    return out


def build_streaming_banks(backgrounds, voices, labels, noises=None,
                          n_chunks: int = 2, n_classes: int = 3,
                          one_hot: bool = True,
                          n_frame: Optional[int] = None,
                          flat_dtype='float32', seed: int = 0,
                          chunk_steps: int = 4,
                          device=None) -> 'StreamingBanks':
    """Host lists -> a :class:`StreamingBanks` rotation of ``n_chunks``
    equal-shape chunks for ``device`` (default ``cuda``), the rotating
    counterpart of ``pipeline.build_banks``, with its label handling."""
    if n_chunks < 2:
        raise ValueError('streaming needs n_chunks >= 2 '
                         '(use build_banks for a resident dataset)')
    labels = np.asarray(labels)
    if one_hot and labels.ndim == 1:
        labels = remap_labels(labels, n_classes)
    rng = np.random.default_rng(seed)
    bg_chunks = _deal(backgrounds, rng.permutation(len(backgrounds)),
                      n_chunks)
    vperm = rng.permutation(len(voices))     # voices and labels stay aligned
    vo_chunks = _deal(voices, vperm, n_chunks)
    lab_chunks = _deal(list(labels), vperm, n_chunks)
    no_chunks = (_deal(noises, rng.permutation(len(noises)), n_chunks)
                 if noises is not None else None)

    def role_banks(chunks, wrap, t_max):
        banks = [build_bank(c, t_max=t_max, wrap_frames=wrap,
                            flat_dtype=flat_dtype, device='cpu')
                 for c in chunks]
        t_flat = max(b.flat.shape[1] for b in banks)
        contig = min(b.contig_exact_frames for b in banks)
        return [dataclasses.replace(_pad_flat_rows(b, t_flat),
                                    contig_exact_frames=contig)
                for b in banks]

    bg_banks = role_banks(bg_chunks, n_frame,
                          max(s.shape[1] for s in backgrounds))
    vo_banks = role_banks(vo_chunks, None, max(s.shape[1] for s in voices))
    no_banks = (role_banks(no_chunks, None, max(s.shape[1] for s in noises))
                if noises is not None else [None] * n_chunks)
    chunks = [Banks(bg, vo, torch.from_numpy(np.stack(lab).astype(np.float32)),
                    no)
              for bg, vo, lab, no in zip(bg_banks, vo_banks, lab_chunks,
                                         no_banks)]
    return StreamingBanks(chunks, chunk_steps=chunk_steps, device=device)


class StreamingBanks:
    """Rotates host chunk banks through ``device`` (default ``cuda``).

    ``next_banks()`` returns the banks of one fused-step dispatch: always
    the same slot object, holding chunk :attr:`current_chunk`; every
    ``chunk_steps`` dispatches the cursor advances, and the next call
    swaps the staged chunk in before it returns. ``peek()`` returns the
    slot without advancing. On a CUDA device the chunks are pinned.
    """

    def __init__(self, chunks: Sequence[Banks], chunk_steps: int = 4,
                 device=None):
        if not chunks:
            raise ValueError('no chunks')
        self.chunks = list(chunks)
        self.chunk_steps = max(int(chunk_steps), 1)
        self._dispatches = 0
        self._idx = 0
        self.set_placement(device)

    def set_placement(self, device) -> None:
        """Upload the chunks to ``device`` from now on (on a mesh, each
        rank's own, every rank holding the whole rotation); drops the
        chunks already uploaded elsewhere. The next use loads the current
        chunk."""
        self.device = resolve_device(device)
        self.cuda = self.device.type == 'cuda'
        if self.cuda:
            self.chunks = [c if c.voices.flat.is_pinned()
                           else map_banks(c, torch.Tensor.pin_memory)
                           for c in self.chunks]
        self._slot = self._staged = None      # device Banks, made at first use
        self._slot_chunk = self._staged_chunk = None
        self._stream = None                   # the uploads' side stream
        self._uploaded = None                 # its event after the last one

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def dispatches(self) -> int:
        """``next_banks()`` calls so far (the rotation's clock)."""
        return self._dispatches

    @property
    def current_chunk(self) -> int:
        """The chunk the next dispatch trains on."""
        return self._idx

    def restore_cursor(self, dispatches: int) -> None:
        """Put the rotation where ``dispatches`` calls of
        :meth:`next_banks` would have left it; the caller derives the count
        from a restored optimizer step (``step // steps_per_call``). The
        chunk at the new cursor is loaded at the next use."""
        dispatches = max(int(dispatches), 0)
        if dispatches == self._dispatches:
            return
        self._dispatches = dispatches
        self._idx = ((dispatches // self.chunk_steps) % self.n_chunks
                     if self.n_chunks > 1 else 0)

    def peek(self) -> Banks:
        """The slot, holding the current chunk, without advancing."""
        self._ensure()
        return self._slot

    def next_banks(self) -> Banks:
        self._ensure()
        self._dispatches += 1
        if self.n_chunks > 1 and self._dispatches % self.chunk_steps == 0:
            self._idx = (self._idx + 1) % self.n_chunks
        return self._slot

    # ---------------------------------------------------------- the card
    def _empty(self) -> Banks:
        return map_banks(self.chunks[0],
                    lambda t: torch.empty_like(t, device=self.device))

    @staticmethod
    def _copy(dst: Banks, src: Banks) -> None:
        for d, s in zip(bank_tensors(dst), bank_tensors(src)):
            d.copy_(s, non_blocking=True)

    def _ensure(self) -> None:
        """The slot holds the current chunk, and the staged buffer the next
        one, or its upload is queued."""
        if self._slot is None:
            self._slot = self._empty()
            if self.n_chunks > 1:
                self._staged = self._empty()
        if self._slot_chunk != self._idx:
            if self._staged_chunk == self._idx:
                self._swap()
            else:
                # after every step queued on the compute stream: a start,
                # or a cursor moved by restore_cursor
                self._copy(self._slot, self.chunks[self._idx])
                self._slot_chunk = self._idx
        nxt = (self._idx + 1) % self.n_chunks
        if self.n_chunks > 1 and self._staged_chunk != nxt:
            self._upload(nxt)

    def _swap(self) -> None:
        """Copy the staged chunk into the slot on the compute stream, after
        its upload and every step queued there."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self._uploaded)
        self._copy(self._slot, self._staged)
        self._slot_chunk, self._staged_chunk = self._staged_chunk, None

    def _upload(self, chunk: int) -> None:
        """Start the upload of ``chunk`` into the staged buffer: on the side
        stream, after everything queued on the compute stream (the last
        swap read the staged buffer)."""
        if self.cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                self._copy(self._staged, self.chunks[chunk])
                self._uploaded = self._stream.record_event()
            for t in bank_tensors(self._staged):
                t.record_stream(self._stream)
        else:
            self._copy(self._staged, self.chunks[chunk])
        self._staged_chunk = chunk
