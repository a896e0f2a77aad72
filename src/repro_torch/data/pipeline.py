"""Training data pipeline as a LOG.io-protected operator dataflow.

Topology (parallelisable with Dispatcher/Merger replicas):

    corpus source -> tokenize/pack -> batcher -> TrainFeedSink
        (replayable read)  (map)      (window)     (train loop)

The TrainFeedSink hands batches to the training loop and acknowledges them
through LOG.io: a batch event's Input Set is marked done only when the train
step consuming it has committed its *checkpoint write action* (checkable on
the checkpoint store), so a crash anywhere in pipeline-or-trainer replays
exactly the unconsumed batches — the paper's exactly-once guarantee applied
to training, with EVENT_LINEAGE linking every checkpoint to the exact source
shards it was trained on.
"""
from __future__ import annotations

import queue
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.builtin import CountWindowOperator, MapOperator
from repro_torch.core.events import Event
from repro_torch.core.operator import Operator, ReadSource


class SyntheticCorpus(ReadSource):
    """Deterministic seeded corpus: shard i is a block of token ids.
    Replayable by construction (same seed => same shards)."""

    def __init__(self, n_shards: int, shard_tokens: int, vocab: int,
                 seed: int = 0):
        self.n_shards, self.shard_tokens = n_shards, shard_tokens
        self.vocab, self.seed = vocab, seed
        super().__init__([], replayable=True)

    def effect(self, desc: str, from_offset: int = 0) -> List[Any]:
        out = []
        for i in range(from_offset, self.n_shards):
            rng = np.random.default_rng(self.seed * 100_003 + i)
            out.append({"shard": i,
                        "tokens": rng.integers(0, self.vocab,
                                               self.shard_tokens,
                                               dtype=np.int32)})
        return out


def pack_fn(seq_len: int) -> Callable[[dict], dict]:
    """Tokenize/pack stub: chops a shard into seq_len+1 sequences."""
    def fn(body):
        toks = body["tokens"]
        n = len(toks) // (seq_len + 1)
        seqs = toks[: n * (seq_len + 1)].reshape(n, seq_len + 1)
        return {"shard": body["shard"], "seqs": seqs}
    return fn


class BatchOperator(CountWindowOperator):
    """Accumulates ``per_batch`` packed shards into one training batch
    (tokens [B, S+1]); the Input Set is the shard window (lineage unit)."""

    def __init__(self, op_id: str, per_batch: int, batch_size: int,
                 **kw):
        def agg(bodies):
            seqs = np.concatenate([b["seqs"] for b in bodies], axis=0)
            return {"tokens": seqs[:batch_size],
                    "shards": sorted(b["shard"] for b in bodies)}
        super().__init__(op_id, window=per_batch, agg=agg, **kw)


class TrainFeedSink(Operator):
    """Hands batches to the train loop; marks a batch's Input Set done only
    when the training step's checkpoint write action commits."""
    output_ports: Tuple[str, ...] = ()

    def __init__(self, op_id: str, *, max_buffer: int = 4):
        super().__init__(op_id)
        self.buffer: "queue.Queue" = queue.Queue(maxsize=max_buffer)
        self._pending: Dict[str, Any] = {}
        self.seen = 0

    def update_global(self, event: Event):
        self.seen += 1

    def global_state(self):
        return {"seen": self.seen}

    def restore_global(self, blob):
        if blob:
            self.seen = blob["seen"]

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self.runtime.new_inset_id()
        self._pending[inset] = event.body
        return [inset]

    def triggers(self) -> List[str]:
        self.requeue()
        return []    # generation is driven by complete()

    def requeue(self):
        """Move pending (acknowledged, not yet consumed) batches into the
        hand-off queue as capacity frees up. Called by the engine thread
        (via triggers) and by the train driver between steps."""
        for inset, body in list(self._pending.items()):
            if body is not None:
                try:
                    self.buffer.put_nowait((inset, body))
                    self._pending[inset] = None      # queued
                except queue.Full:
                    break

    def has_pending(self) -> bool:
        return bool(self._pending)

    def complete(self, inset: str, step: int, ckpt_ref: Optional[str]):
        """Called by the train driver after the step (and any checkpoint
        write) committed: the generation for this Input Set emits the
        checkpoint write action and marks the batch events done."""
        self._finish_args = (step, ckpt_ref)
        self.runtime.generate(inset)
        self.requeue()

    def generate(self, inset_id: str):
        step, ckpt_ref = getattr(self, "_finish_args", (None, None))
        writes = []
        if ckpt_ref is not None:
            writes.append(("ckpt", {"step": step, "ref": ckpt_ref}))
        return [], writes

    def clear_inset(self, inset_id: str):
        self._pending.pop(inset_id, None)


def build_data_pipeline(*, seq_len: int, batch_size: int, vocab: int,
                        n_shards: int = 64, shard_tokens: int = 4096,
                        per_batch: int = 2, seed: int = 0):
    """Returns (Pipeline, sink_id) for the standard training feed."""
    from repro_torch.core.engine import Pipeline
    from repro_torch.core.builtin import GeneratorSource

    corpus = SyntheticCorpus(n_shards, shard_tokens, vocab, seed)
    p = Pipeline()
    p.add(lambda: GeneratorSource("corpus", corpus, desc="corpus-read"))
    p.add(lambda: MapOperator("pack", fn=pack_fn(seq_len)))
    p.add(lambda: BatchOperator("batch", per_batch, batch_size))
    p.add(lambda: TrainFeedSink("feed"))
    p.connect("corpus", "out", "pack", "in")
    p.connect("pack", "out", "batch", "in")
    p.connect("batch", "out", "feed", "in")
    return p, "feed"
