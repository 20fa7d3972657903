"""Streaming input pipeline (counterpart of seed_tpu/data/pipeline.py).

Composable generators in place of torchdata / webdataset: shard listing ->
per-process shard -> cycle -> tar -> webdataset grouping -> decode ->
shuffle buffer -> batch -> collate, and a background thread that keeps the
next batches ready.

Every random choice goes through ``random.Random(seed)`` with the same calls
in the same order as seed_tpu, so the same shards and seed give the same
records in the same order. The process index that picks a process's shards
comes from ``torch.distributed`` when it is initialised (seed_tpu asks
``jax.process_index``); otherwise the process is 0 of 1.
"""
from __future__ import annotations

import glob as globlib
import io
import itertools
import json
import logging
import pickle
import queue as queuelib
import random
import tarfile
import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

log = logging.getLogger("seed_tpu_torch.data")


def process_index_count() -> Tuple[int, int]:
    """(index, count) of this process's data shard: under a mesh
    (``parallel.mesh.current_mesh``) its index along (data, fsdp) and their
    product, so that the ranks of one batch slice (its tensor and pipe
    peers) read the same files; else the torch.distributed rank and world
    size; (0, 1) when no process group is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from ..parallel.mesh import BATCH_AXES, axis_index, axis_size, current_mesh
        mesh = current_mesh()
        if mesh is not None:
            return axis_index(BATCH_AXES, mesh), axis_size(BATCH_AXES, mesh)
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ----------------------------- shard listing -------------------------------

def list_shards(pattern: str, shuffle_seed: Optional[int] = None) -> List[str]:
    files = sorted(globlib.glob(pattern))
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(files)
    return files


def shard_for_host(files: Sequence[str], host_index: Optional[int] = None,
                   host_count: Optional[int] = None) -> List[str]:
    """Round-robin shard assignment per process (DistributedReadingService)."""
    if host_index is None:
        host_index, host_count = process_index_count()
    return [f for i, f in enumerate(files) if i % host_count == host_index]


# ----------------------------- tar reading ---------------------------------

def iter_tar(path: str, suffixes: Optional[Sequence[str]] = None
             ) -> Iterator[Tuple[str, bytes]]:
    """Yield (member_name, bytes); a corrupt archive is skipped with a
    warning instead of raising (load_from_tar_wo_exception semantics)."""
    try:
        with tarfile.open(path, "r") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                if suffixes and not any(member.name.endswith(s) for s in suffixes):
                    continue
                f = tf.extractfile(member)
                if f is None:
                    continue
                yield member.name, f.read()
    except (tarfile.TarError, EOFError, OSError) as e:
        log.warning("skipping corrupt tar %s: %s", path, e)


def group_by_key(stream: Iterator[Tuple[str, bytes]]
                 ) -> Iterator[Dict[str, bytes]]:
    """webdataset grouping: 'abc.jpg', 'abc.txt' -> {'__key__', 'jpg',
    'txt'}; a repeated key flushes the previous sample
    (group_by_keys_nothrow)."""
    current: Dict[str, Any] = {}
    for name, data in stream:
        key, _, ext = name.rpartition("/")[2].partition(".")
        if current and current.get("__key__") != key:
            yield current
            current = {}
        current["__key__"] = key
        current[ext] = data
    if current:
        yield current


def decode_pkl_records(sample: Dict[str, bytes]) -> Optional[Dict[str, Any]]:
    """Pre-tokenized record (the ShardWriter pkl format); a corrupt record
    is skipped. Shards are unpickled, so read only shards this project
    wrote."""
    if "pkl" not in sample:
        return None
    try:
        return pickle.loads(sample["pkl"])
    except Exception as e:  # corrupt record: skip, don't end the epoch
        log.warning("bad pkl record %s: %s", sample.get("__key__"), e)
        return None


def _image_text(sample: Dict[str, bytes], convert: bool
                ) -> Optional[Dict[str, Any]]:
    img_ext = next((e for e in ("jpg", "jpeg", "png", "webp") if e in sample),
                   None)
    if img_ext is None:
        return None
    try:
        from PIL import Image
        img = Image.open(io.BytesIO(sample[img_ext]))
        if convert:
            img = img.convert("RGB")
    except Exception as e:
        log.warning("bad image %s: %s", sample.get("__key__"), e)
        return None
    out = {"__key__": sample.get("__key__"), "image": img}
    if "txt" in sample:
        out["text"] = sample["txt"].decode("utf-8", errors="replace")
    if "json" in sample:
        try:
            out["meta"] = json.loads(sample["json"])
        except ValueError:
            pass
    return out


def decode_image_text(sample: Dict[str, bytes]) -> Optional[Dict[str, Any]]:
    """Raw webdataset sample: jpg + txt (+ json) -> dict with an RGB PIL
    image."""
    return _image_text(sample, convert=True)


def decode_image_text_lazy(sample: Dict[str, bytes]) -> Optional[Dict[str, Any]]:
    """Like :func:`decode_image_text` but the PIL image stays lazy (no
    convert, no pixel decode), so :func:`resize_draft` can set the JPEG
    draft scale before the only decode. A payload corrupt past the header
    raises at resize time; the consumer skips it."""
    return _image_text(sample, convert=False)


def resize_draft(img, size: int):
    """Training-path resize with a JPEG draft decode (libjpeg decodes at the
    smallest DCT scale >= the target), then one resize. Its pixels differ
    from a full-resolution decode in the last bit: training streams only;
    inference keeps ops/preprocess."""
    img.draft("RGB", (size, size))   # no-op for non-JPEG / already loaded
    return img.convert("RGB").resize((size, size))


# ----------------------------- combinators ---------------------------------

def cycle(items: Sequence[str], count: Optional[int] = None,
          seed: Optional[int] = None) -> Iterator[str]:
    """Repeat the file list ``count`` times (None = forever), reshuffled per
    epoch with the seed ``seed + epoch`` (detshuffle2)."""
    epoch = 0
    while count is None or epoch < count:
        files = list(items)
        if seed is not None:
            random.Random(seed + epoch).shuffle(files)
        yield from files
        epoch += 1


def resampled_shards(files: Sequence[str], seed: int = 0,
                     epoch_size: Optional[int] = None) -> Iterator[str]:
    """Sample shards with replacement (ResampledShards2)."""
    rng = random.Random(seed)
    count = 0
    while True:
        yield rng.choice(list(files))
        count += 1
        if epoch_size is not None and count >= epoch_size:
            return


def shuffle_buffer(stream: Iterator, size: int, seed: int = 0) -> Iterator:
    rng = random.Random(seed)
    buf: List[Any] = []
    for item in stream:
        if len(buf) < size:
            buf.append(item)
            continue
        i = rng.randrange(size)
        yield buf[i]
        buf[i] = item
    rng.shuffle(buf)
    yield from buf


def batched(stream: Iterator, batch_size: int,
            collate: Optional[Callable] = None, drop_last: bool = True
            ) -> Iterator:
    it = iter(stream)
    while True:
        chunk = list(itertools.islice(it, batch_size))
        if not chunk or (drop_last and len(chunk) < batch_size):
            return
        yield collate(chunk) if collate else chunk


def sample_multiplexer(sources: Dict[str, Iterator], weights: Dict[str, float],
                       seed: int = 0) -> Iterator:
    """Weighted sampling across sources; a source that ends is dropped
    (SampleMultiplexer). Ends when every source has ended."""
    rng = random.Random(seed)
    live = {k: iter(v) for k, v in sources.items()}
    w = {k: float(weights.get(k, 1.0)) for k in live}
    while live:
        names = list(live)
        pick = rng.choices(names, weights=[w[n] for n in names], k=1)[0]
        try:
            yield next(live[pick])
        except StopIteration:
            del live[pick]


def multiplexer_longest(sources: Dict[str, Iterator], seed: int = 0) -> Iterator:
    """Round-robin until every source is exhausted (MultiplexerLongest)."""
    live = {k: iter(v) for k, v in sources.items()}
    while live:
        for name in list(live):
            try:
                yield next(live[name])
            except StopIteration:
                del live[name]


# --------------------------- device feeding --------------------------------

class Prefetcher:
    """Iterates ``stream`` in a background thread, ``depth`` items ahead.

    An exception raised by the stream is raised again by ``__next__`` (after
    the items made before it). ``close`` stops the thread: call it when the
    consumer stops early, so the producer does not hold the stream (and
    whatever device work its items do) after the consumer is gone."""

    def __init__(self, stream: Iterator, depth: int = 2,
                 transfer: Optional[Callable] = None):
        self._q: queuelib.Queue = queuelib.Queue(maxsize=depth)
        self._stream = stream
        self._transfer = transfer
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queuelib.Full:
                continue
        return False

    def _fill(self):
        try:
            for item in self._stream:
                if self._transfer:
                    item = self._transfer(item)
                if not self._put(item):
                    return
        except Exception as e:       # handed to the consumer by __next__
            self._error = e
        self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)          # later calls end too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queuelib.Empty:
                self._thread.join(0.1)
                timeout -= 0.1
                if timeout <= 0:
                    raise TimeoutError("Prefetcher: the producer did not stop")


def quality_filter(sample: Dict[str, Any],
                   min_resolution: int = 128,
                   max_aspect_ratio: float = 3.0,
                   min_similarity: Optional[float] = None,
                   min_caption_len: int = 1,
                   max_caption_len: int = 512) -> bool:
    """Resolution / aspect-ratio / CLIP-similarity / caption-length gates
    (torchdata_preprocess.py:174-237). True if the sample passes."""
    img = sample.get("image")
    if img is not None:
        w, h = img.size if hasattr(img, "size") else (img.shape[1], img.shape[0])
        if min(w, h) < min_resolution:
            return False
        if max(w, h) / max(1, min(w, h)) > max_aspect_ratio:
            return False
    text = sample.get("text")
    if text is not None:
        n_words = len(str(text).split())
        if not (min_caption_len <= n_words <= max_caption_len):
            return False
    if min_similarity is not None:
        sim = (sample.get("meta") or {}).get("similarity")
        if sim is not None and sim < min_similarity:
            return False
    return True


# ------------------------------ sources ------------------------------------

def lmdb_ids_source(meta_path: str, lmdb_dir: str,
                    get_fn: Optional[Callable[[str], Optional[bytes]]] = None,
                    host_index: Optional[int] = None,
                    host_count: Optional[int] = None) -> Iterator[Dict]:
    """CC3M-style reader (cc3m.py:15-47): a TSV of ``caption<TAB>img_name``
    rows and a store mapping img_name -> pickled SEED image ids. Yields
    ``{"caption", "image_ids"}``; rows whose key the store lacks are
    skipped. ``get_fn`` replaces the LMDB lookup; without it the ``lmdb``
    package is needed. Rows are split across processes like shards."""
    if get_fn is None:
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "lmdb_ids_source needs the 'lmdb' package (or pass get_fn=)"
            ) from e
        env = lmdb.open(lmdb_dir, readonly=True, max_readers=1024,
                        create=False, lock=False)
        txn = env.begin(buffers=False)
        get_fn = lambda k: txn.get(k.encode("utf-8"))
    if host_index is None:
        host_index, host_count = process_index_count()
    hi, hc = host_index, host_count or 1
    with open(meta_path) as f:
        for lineno, line in enumerate(f):
            if lineno % hc != hi:
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            caption, img_name = parts[0], parts[1]
            raw = get_fn(img_name)
            if raw is None:
                continue
            yield {"caption": caption, "image_ids": list(pickle.loads(raw))}


def tar_source(pattern: str, decode: Callable = decode_pkl_records,
               cycle_count: Optional[int] = 1, seed: int = 0,
               host_index: Optional[int] = None,
               host_count: Optional[int] = None) -> Iterator[Dict]:
    """files -> per-process shard -> cycle -> tar -> group -> decode ->
    filter."""
    files = shard_for_host(list_shards(pattern), host_index, host_count)
    for path in cycle(files, cycle_count, seed):
        for sample in group_by_key(iter_tar(path)):
            rec = decode(sample)
            if rec is not None:
                yield rec
