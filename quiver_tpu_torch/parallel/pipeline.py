"""Input-pipeline prefetching: overlap sample and gather with the train step.

The port of ``quiver_tpu/parallel/pipeline.py``. :class:`Prefetcher` keeps
``depth`` batches in flight on one worker thread, so batch i+1's sample
and gather run while the train step of batch i computes (the reference
overlaps its stages with CUDA streams, quiver_sample.cu:84-88).

On a card the worker dispatches on a CUDA stream of its own (one per
:meth:`Prefetcher.run`, from PyTorch's pool of non-blocking streams, on
the device of the feature store or else the sampler), after
``torch.cuda.set_device`` to that device: PyTorch's current stream and
current device are per thread. Host syncs in the dispatch (the auto
frontier caps' readback, the ``"xla"`` lookup's cold-row ids) wait on
that stream only. Each batch records an event after its dispatch; the
consumer's current stream waits on it before the batch is yielded, and
every CUDA tensor of the batch (``n_id``, the Adjs, ``x``, whatever
``transform`` returns) is marked used on the consumer's stream
(``record_stream``), so the caching allocator does not hand the worker a
block the consumer's step still reads.

A single worker keeps the sampler's call order, so the prefetched stream
is bitwise the sequential loop's. Transient failures of the sampler, the
feature store or ``transform`` are retried with bounded exponential
backoff and deterministic jitter; a batch still failing after its
retries either surfaces at its yield (``skip_policy="raise"``, the
default; a worker's CUDA error too) or is dropped and counted
(``"skip"``). ``timeline``, ``metrics`` and ``tracer`` see the
``prefetch.*`` stages, counters, queue-depth gauge and spans.
"""

from __future__ import annotations

import collections
import concurrent.futures
import random
import time
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ..obs.registry import (PREFETCH_QUEUE_DEPTH, PREFETCH_RETRIES,
                            PREFETCH_SKIPS)
from ..utils.trace import get_logger

__all__ = ["Batch", "PipelinedBatch", "Prefetcher"]

_SKIP_POLICIES = ("raise", "skip")


class Batch(NamedTuple):
    """One ready-to-train batch: features + sampler output."""

    seeds: object  # the raw seed array this batch was built from
    out: object  # SampleOutput (n_id, batch_size, adjs, ...)
    x: object  # gathered feature rows for out.n_id


class PipelinedBatch(NamedTuple):
    """One sample-and-gather result carried across a one-step skew by a
    software-pipelined epoch (the JAX package's ``DistributedTrainer``
    with ``pipeline_depth=1``; in the port, a type only until its trainer
    lands). Every array has a leading per-device block axis."""

    n_id: object  # (bpd, total_cap) int32 gathered node ids per block
    x: object  # (bpd, cap, F) gathered feature rows per block
    adjs: object  # tuple of Adj, edge_index leaves stacked to (bpd, 2, E)
    num_seeds: object  # (bpd,) int32 valid-seed count per block
    metrics: object  # the issue half's metrics dict ({} when disabled)


class _Skipped(NamedTuple):
    """Worker-side marker for a batch dropped under skip_policy="skip"."""

    seeds: object
    error: BaseException


def _cuda_tensors(obj, depth: int = 0):
    """Every CUDA tensor inside a batch: tensors, sequences, dicts and the
    attributes of plain objects (``Adj``), a few levels deep."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
    elif depth > 4 or obj is None or isinstance(obj, (str, bytes, np.ndarray)):
        return
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _cuda_tensors(v, depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _cuda_tensors(v, depth + 1)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            yield from _cuda_tensors(v, depth + 1)


def _device_of(*objs) -> torch.device | None:
    """The CUDA device of the first object whose ``device`` is one."""
    for obj in objs:
        dev = getattr(obj, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return dev
    return None


class Prefetcher:
    """Iterate (seeds -> Batch) with ``depth`` batches dispatched ahead.

    Args:
      sampler: GraphSageSampler (or any object with .sample(seeds)).
      feature: Feature (or any ids -> rows indexable); None prefetches
        sampling only.
      depth: max batches in flight beyond the one being consumed (2 =
        double buffering).
      transform: optional callback (seeds, out, x) -> Batch-like, run on
        the worker thread (and its stream), e.g. a label lookup.
      retries: max re-dispatches per batch after a raising sample, gather
        or transform (0 = fail fast). A retry re-enters the whole
        dispatch, so a sampler that failed before drawing keeps its call
        order: the recovered stream is bitwise a fault-free one.
      backoff: first retry delay in seconds; doubles per attempt, capped
        at ``backoff_cap``.
      backoff_cap: upper bound on one backoff sleep.
      jitter: fractional random pad on each sleep (delay *= 1 + U[0,1) *
        jitter), drawn from ``random.Random(retry_seed)``.
      skip_policy: when retries run out, ``"raise"`` surfaces the
        exception at the batch's yield; ``"skip"`` drops the batch,
        counts it (``skips_total``) and keeps streaming.
      timeline: optional ``StepTimeline``-like registry (``observe(name,
        seconds)``) fed ``prefetch.dispatch`` (each successful dispatch's
        wall time), ``prefetch.retry_wait`` (each backoff sleep) and
        ``prefetch.skip`` (each dropped batch).
      metrics: optional ``MetricsRegistry`` holding the lifetime counters
        ``prefetch.retries`` and ``prefetch.skipped_batches`` and the
        gauge ``prefetch.queue_depth`` (batches in flight).
      retry_seed: seed of the jitter's PRNG.
      tracer: optional ``Tracer``: each successful dispatch lands a
        ``prefetch.dispatch`` span (subsystem ``prefetch``) tagged with
        the batch's stream index and the ``trace`` id.
      trace: trace id the dispatch spans attach to.

    ``retries_total`` / ``skips_total`` count over the prefetcher's
    lifetime (written by the single worker thread only).

    >>> for batch in Prefetcher(sampler, feature).run(seed_stream):
    ...     loss = train_step(batch.x, batch.out.adjs, ...)
    """

    def __init__(
        self,
        sampler,
        feature=None,
        depth: int = 2,
        transform: Callable | None = None,
        retries: int = 0,
        backoff: float = 0.05,
        backoff_cap: float = 2.0,
        jitter: float = 0.5,
        skip_policy: str = "raise",
        timeline=None,
        metrics=None,
        retry_seed: int = 0,
        tracer=None,
        trace: str | None = None,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if backoff < 0 or backoff_cap < 0 or jitter < 0:
            raise ValueError(
                f"backoff/backoff_cap/jitter must be >= 0, got "
                f"{backoff}/{backoff_cap}/{jitter}"
            )
        if skip_policy not in _SKIP_POLICIES:
            raise ValueError(
                f"skip_policy must be one of {_SKIP_POLICIES}, "
                f"got {skip_policy!r}"
            )
        self.sampler = sampler
        self.feature = feature
        self.depth = depth
        self.transform = transform
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.jitter = float(jitter)
        self.skip_policy = skip_policy
        self.timeline = timeline
        self.metrics = metrics
        if metrics is not None:
            metrics.counter(
                PREFETCH_RETRIES, unit="dispatches",
                doc="prefetch batch re-dispatches after a raising "
                    "sample/gather/transform (lifetime total)",
            )
            metrics.counter(
                PREFETCH_SKIPS, unit="batches",
                doc="poisoned batches dropped after retries exhausted "
                    "(skip_policy='skip'; lifetime total)",
            )
            metrics.gauge(
                PREFETCH_QUEUE_DEPTH, unit="batches",
                doc="batches currently in flight on the prefetch worker "
                    "(pinned at `depth` while the pipeline keeps up; "
                    "sagging below it means dispatch is the bottleneck)",
            )
        self._jitter_rng = random.Random(retry_seed)
        self.tracer = tracer
        self.trace = trace
        self.device = _device_of(feature, sampler)
        self._batch_index = 0  # worker-thread only (single worker)
        self.retries_total = 0
        self.skips_total = 0

    def _observe(self, stage: str, seconds: float) -> None:
        if self.timeline is not None:
            self.timeline.observe(stage, seconds)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.observe(
                stage, seconds, trace=self.trace, subsystem="prefetch",
                batch=self._batch_index,
            )

    def _publish_counters(self) -> None:
        """Land the running totals on the registry (from the worker, the
        one thread that increments them)."""
        if self.metrics is not None:
            self.metrics.set(PREFETCH_RETRIES, np.int32(self.retries_total))
            self.metrics.set(PREFETCH_SKIPS, np.int32(self.skips_total))

    def _dispatch(self, seeds):
        out = self.sampler.sample(seeds)
        x = None if self.feature is None else self.feature[out.n_id]
        if self.transform is not None:
            return self.transform(seeds, out, x)
        return Batch(seeds, out, x)

    def _dispatch_on(self, seeds, stream):
        """One batch on the worker's ``stream`` (None off the card), with
        the event the consumer waits on."""
        if stream is None:
            return self._dispatch_resilient(seeds), None
        torch.cuda.set_device(stream.device)
        with torch.cuda.stream(stream):
            batch = self._dispatch_resilient(seeds)
            done = torch.cuda.Event()
            done.record(stream)
        return batch, done

    def _dispatch_resilient(self, seeds):
        """One batch with bounded retry; runs on the worker thread."""
        self._batch_index += 1
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                batch = self._dispatch(seeds)
            except Exception as e:  # noqa: BLE001 (bounded retry, then
                if attempt >= self.retries:  # surface or skip per policy)
                    if self.skip_policy == "skip":
                        self.skips_total += 1
                        self._observe("prefetch.skip", 0.0)
                        self._publish_counters()
                        get_logger().warning(
                            "prefetch: batch dropped after %d retr%s "
                            "(skip_policy='skip'): %s: %s",
                            attempt, "y" if attempt == 1 else "ies",
                            type(e).__name__, e,
                        )
                        return _Skipped(seeds, e)
                    raise
                attempt += 1
                self.retries_total += 1
                self._publish_counters()
                delay = min(
                    self.backoff * 2.0 ** (attempt - 1), self.backoff_cap
                ) * (1.0 + self.jitter * self._jitter_rng.random())
                self._observe("prefetch.retry_wait", delay)
                if delay > 0:
                    time.sleep(delay)
            else:
                self._observe("prefetch.dispatch", time.perf_counter() - t0)
                return batch

    def run(self, seed_stream: Iterable) -> Iterator[Batch]:
        """Yield Batches for each seed array in ``seed_stream``, keeping up
        to ``depth`` in flight. Exceptions from the worker (after any
        retries) surface at the yield of the offending batch, in order;
        under ``skip_policy="skip"`` the failed batch is dropped from the
        stream instead (later batches keep their order).

        A consumer that stops early (``break`` / ``gen.close()``) returns
        promptly: queued dispatches are cancelled and the pool is shut
        down WITHOUT joining the worker, which finishes its one in-flight
        dispatch in the background and exits."""
        stream = consumer = None
        if self.device is not None:
            consumer = torch.cuda.current_stream(self.device)
            stream = torch.cuda.Stream(self.device)
            # whatever the consumer enqueued before the run (tables,
            # placements) is visible to the worker's first dispatch
            stream.wait_stream(consumer)
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="quiver-prefetch"
        )
        inflight: collections.deque = collections.deque()

        def _note_depth() -> None:
            # consumer-thread write; the worker never touches this gauge
            if self.metrics is not None:
                self.metrics.set(PREFETCH_QUEUE_DEPTH, np.int32(len(inflight)))

        def _take():
            batch, done = inflight.popleft().result()
            _note_depth()
            if done is not None and not isinstance(batch, _Skipped):
                consumer.wait_event(done)
                for t in _cuda_tensors(batch):
                    t.record_stream(consumer)
            return batch

        try:
            for seeds in seed_stream:
                inflight.append(pool.submit(self._dispatch_on, seeds, stream))
                _note_depth()
                if len(inflight) > self.depth:
                    batch = _take()
                    if not isinstance(batch, _Skipped):
                        yield batch
            while inflight:
                batch = _take()
                if not isinstance(batch, _Skipped):
                    yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    __call__ = run
