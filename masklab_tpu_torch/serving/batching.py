"""Server-side micro-batching.

Port of ``default_buckets``, ``_next_bucket`` and ``MicroBatcher``
(``masklab_tpu/serving/batching.py:31-249``): concurrent requests queue up
and a dispatcher thread drains same-(resolution, mode) groups into one
padded device batch. Batch sizes are bucketed (1, 2, 4, ... max_batch); a
bucket whose first run fails is suspended with a doubling cooldown and its
group retried at a strictly smaller bucket, while a bucket that has served
before passes a later failure to its callers and stays in service. One
request alone leaves after ``window_ms``.

And of ``CheckpointWatcher`` (``:252-305``): checkpoint hot-reload. It
polls a checkpoint directory for a new best checkpoint (``train/
checkpoints.py``, whose ``best_checkpoint`` skips the ``tmp`` names a save
is still writing), has the predictor build a model from it off to the side
(``place_variables``: on the predictor's device, its weights cast once),
then swaps it in with one reference assignment, so a request in flight
runs on the old model or the new one, never on a half-loaded one.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two below ``max_batch``, then ``max_batch``."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _Pending:
    __slots__ = ('image', 'mode', 'event', 'result', 'error')

    def __init__(self, image: np.ndarray, mode: Optional[str] = None):
        self.image = image
        self.mode = mode
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Groups concurrent ``submit`` calls into batched ``predict`` calls.

    ``predict`` takes a stacked uint8 batch [B, H, W, 3] (and a mode, when
    the request names one) and returns a dict of batch-leading arrays
    (``MaskLabPredictor.predict``). The images of one call share a
    resolution and a mode; a mixed queue drains as separate groups, the
    largest first.
    """

    def __init__(self, predict: Callable[..., Dict[str, np.ndarray]],
                 max_batch: int = 8, window_ms: float = 4.0,
                 buckets: Optional[Sequence[int]] = None,
                 evict_cooldown_s: float = 120.0):
        if buckets is None:
            buckets = default_buckets(max_batch)
        self.predict = predict
        self.max_batch = min(max_batch, buckets[-1])
        self.window_s = window_ms / 1000.0
        self.buckets = tuple(buckets)
        self.evict_cooldown_s = evict_cooldown_s
        self._lock = threading.Condition()
        self._queue: List[_Pending] = []
        self._closed = False
        # buckets that have completed a predict (a later failure there is
        # transient and reaches the callers), and suspended buckets with
        # (retry_at, cooldown)
        self._warm: set = set()
        self._suspended: Dict[int, tuple] = {}
        self.batch_sizes = deque(maxlen=1024)   # the bucket of each call
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def eligible_buckets(self) -> Tuple[int, ...]:
        """Buckets in service (a suspension past its cooldown counts)."""
        now = time.monotonic()
        with self._lock:
            elig = tuple(b for b in self.buckets
                         if b not in self._suspended
                         or self._suspended[b][0] <= now)
        return elig or (1,)

    # ---- client side ----

    def submit(self, image: np.ndarray,
               mode: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Blocks until the batched result for ``image`` [H, W, 3] is in;
        only requests of the same (resolution, mode) share a call."""
        item = _Pending(image, mode)
        with self._lock:
            if self._closed:
                raise RuntimeError('MicroBatcher is closed')
            self._queue.append(item)
            self._lock.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join(timeout=5.0)

    # ---- dispatcher ----

    def _take_group(self) -> List[_Pending]:
        """The largest same-(resolution, mode) group, up to max_batch
        (holds _lock)."""
        by_key: Dict[tuple, List[_Pending]] = {}
        for item in self._queue:
            by_key.setdefault((item.image.shape[:2], item.mode),
                              []).append(item)
        group = max(by_key.values(), key=len)[:self.max_batch]
        taken = set(map(id, group))
        self._queue = [i for i in self._queue if id(i) not in taken]
        return group

    def _loop(self):
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                if self._closed and not self._queue:
                    return
            # batching window: let closely spaced requests coalesce
            deadline = time.monotonic() + self.window_s
            while time.monotonic() < deadline:
                with self._lock:
                    if len(self._queue) >= self.max_batch:
                        break
                time.sleep(self.window_s / 8.0)
            with self._lock:
                group = self._take_group()
            self._run(group)

    def _run(self, group: List[_Pending], cap: Optional[int] = None):
        # every failure from here on must reach the waiters: an exception
        # escaping this method would end the dispatcher thread and leave
        # every submit() waiting forever. ``cap``: a retry after a bucket's
        # first-run failure goes to a strictly smaller bucket.
        elig = self.eligible_buckets()
        if cap is not None:
            elig = tuple(b for b in elig if b < cap) or (1,)
        bucket = _next_bucket(len(group), elig)
        if len(group) > bucket:
            # the larger buckets are suspended: serve bucket-sized waves
            for i in range(0, len(group), bucket):
                self._run(group[i:i + bucket], cap=cap)
            return
        try:
            images = np.stack([i.image for i in group])
            if bucket > len(group):
                pad = np.zeros((bucket - len(group),) + images.shape[1:],
                               images.dtype)
                images = np.concatenate([images, pad])
        except BaseException as exc:  # noqa: BLE001 - a malformed request
            self._fail(group, exc)
            return
        self.batch_sizes.append(bucket)
        try:
            out = (self.predict(images) if group[0].mode is None
                   else self.predict(images, group[0].mode))
        except BaseException as exc:  # noqa: BLE001
            # SystemExit included: it must reach the waiters, not end the
            # dispatcher (KeyboardInterrupt only reaches the main thread)
            if bucket <= 1:
                self._fail(group, exc)
                return
            with self._lock:
                warm = bucket in self._warm
            if warm:
                # this bucket has served: a transient failure, which
                # reaches the callers and changes no bucket
                self._fail(group, exc)
                return
            # a first-run failure: suspend the bucket with a doubling
            # cooldown and retry the group at a smaller one
            self._suspend_bucket(bucket, exc)
            self._run(group, cap=bucket)
            return
        with self._lock:
            self._warm.add(bucket)
            self._suspended.pop(bucket, None)
        for k, item in enumerate(group):
            item.result = {key: val[k:k + 1] for key, val in out.items()}
            item.event.set()

    @staticmethod
    def _fail(group: List[_Pending], exc: BaseException):
        for item in group:
            item.error = exc
            item.event.set()

    def _suspend_bucket(self, bucket: int, exc: BaseException):
        with self._lock:
            prev = self._suspended.get(bucket)
            cooldown = min(prev[1] * 2.0, 3600.0) if prev else \
                self.evict_cooldown_s
            self._suspended[bucket] = (time.monotonic() + cooldown, cooldown)
            current = max(self.eligible_buckets())
        print(f'MicroBatcher: batch bucket {bucket} failed its first run '
              f'({type(exc).__name__}: {str(exc)[:200]}); suspended for '
              f'{cooldown:.0f}s; serving continues at max batch {current}',
              file=sys.stderr, flush=True)


class CheckpointWatcher:
    """Polls ``save_dir`` for a new best checkpoint and hot-swaps the
    predictor's model (TF-Serving's version-directory polling, on the
    port's torch checkpoints).

    ``restore(path)`` gives a checkpoint's variables (default: the
    checkpoint manager's ``restore_variables``); the predictor's
    ``place_variables(variables)`` builds the model that serves them, and
    ``predictor.model`` is then replaced in one assignment. ``current`` is
    the checkpoint being served (None until the first swap). A failure in
    the poll thread keeps the old model; ``check_once`` raises it."""

    def __init__(self, predictor, save_dir: str, poll_s: float = 10.0,
                 restore: Optional[Callable[[str], Dict]] = None):
        if not callable(getattr(predictor, 'place_variables', None)):
            raise TypeError('CheckpointWatcher needs a predictor with '
                            'place_variables(variables) to build the model '
                            'it swaps in')
        self.predictor = predictor
        self.save_dir = save_dir
        self.poll_s = poll_s
        self._restore = restore or self._default_restore
        self.current: Optional[str] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_restore(ckpt_dir: str) -> Dict:
        from ..train.checkpoints import CheckpointManager
        return CheckpointManager(os.path.dirname(ckpt_dir),
                                 None).restore_variables(ckpt_dir)

    def check_once(self) -> bool:
        """One poll; True if a new version was swapped in. Polls from the
        thread and from ``/reload`` take turns."""
        from ..train.checkpoints import CheckpointManager
        with self._lock:
            if not os.path.isdir(self.save_dir):
                return False
            best = CheckpointManager(self.save_dir, None).best_checkpoint()
            if best is None or best == self.current:
                return False
            model = self.predictor.place_variables(self._restore(best))
            self.predictor.model = model         # the swap: one assignment
            self.current = best
            return True

    def start(self):
        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.check_once()
                except Exception:  # noqa: BLE001 - keep serving the old one
                    pass
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
