"""ctypes bindings for the native tar loader and JPEG decoder
(counterpart of seed_tpu/native/; ``tarloader.cpp`` is the same source).

The library is built at first use with g++ (``-ljpeg -pthread``) into
``build/seed_tpu_torch/`` of the checkout, named after a digest of the
source, never next to it. When the build fails (no compiler, no libjpeg
headers) ``available()`` is False, the compiler's message is logged and kept
in ``build_error()``, and callers take the Python path, as seed_tpu's do; a
caller that reaches ``tar_index`` with no library gets seed_tpu's
RuntimeError.
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("seed_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "tarloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "seed_tpu_torch"
_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


class _TarEntry(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_int64), ("size", ctypes.c_int64),
                ("name", ctypes.c_char * 200)]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libtarloader-{digest}.so"


def _build(so: Path) -> Optional[Path]:
    global _error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(SRC), "-o", str(tmp),
           "-ljpeg", "-pthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _error = f"{' '.join(cmd)}: {e}"
    else:
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        _error = proc.stderr.strip() or f"g++ exited {proc.returncode}"
    log.warning("native tarloader build failed; using the Python path:\n%s",
                _error)
    return None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and _build(so) is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.tar_index.restype = ctypes.c_int64
        lib.tar_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(_TarEntry),
                                  ctypes.c_int64]
        lib.tar_read_batch.restype = ctypes.c_int
        lib.tar_read_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.jpeg_decode_resize_batch.restype = ctypes.c_int
        lib.jpeg_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """The compiler's message of a failed build (None if it built or was
    not tried)."""
    return _error


def tar_index(path: str, max_entries: int = 1 << 20
              ) -> List[Tuple[str, int, int]]:
    """[(name, offset, size)] for all regular files in an uncompressed tar."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native tarloader unavailable")
    buf = (_TarEntry * max_entries)()
    n = lib.tar_index(path.encode(), buf, max_entries)
    if n < 0:
        raise IOError(f"tar_index failed for {path}")
    return [(buf[i].name.decode(errors="replace"), buf[i].offset, buf[i].size)
            for i in range(n)]


def tar_read_batch(path: str, entries: Sequence[Tuple[int, int]]
                   ) -> List[bytes]:
    """Read [(offset, size)] members in one native call."""
    lib = get_lib()
    offsets = np.asarray([e[0] for e in entries], np.int64)
    sizes = np.asarray([e[1] for e in entries], np.int64)
    dst = np.empty(int(sizes.sum()), np.uint8)
    rc = lib.tar_read_batch(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(entries), dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"tar_read_batch failed rc={rc}")
    out, pos = [], 0
    for s in sizes:
        out.append(dst[pos:pos + int(s)].tobytes())
        pos += int(s)
    return out


def jpeg_decode_resize(jpegs: Sequence[bytes], out_h: int, out_w: int,
                       threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Batch JPEG decode+resize -> (images [N,H,W,3] u8, ok [N] bool)."""
    lib = get_lib()
    n = len(jpegs)
    sizes = np.asarray([len(j) for j in jpegs], np.int64)
    src = np.frombuffer(b"".join(jpegs), np.uint8)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.int8)
    threads = threads or min(os.cpu_count() or 4, 16)
    lib.jpeg_decode_resize_batch(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), threads)
    return out, ok.astype(bool)


def _is_jpeg(name: str) -> bool:
    return name.lower().endswith((".jpg", ".jpeg"))


def fast_image_batches(paths: Sequence[str], batch_size: int, image_size: int,
                       suffixes=(".jpg", ".jpeg", ".png", ".webp")):
    """Native-path image pipeline: tar index -> batched reads -> parallel
    decode+resize. Yields (images [B,H,W,3] u8, keys, texts). PNG/WebP
    members fall back to PIL decode."""
    texts: dict = {}

    def flush(path, batch):
        names = [b[2] for b in batch]
        raw = tar_read_batch(path, [b[1] for b in batch])
        jpeg_items = [(i, r) for i, (r, nm) in enumerate(zip(raw, names))
                      if _is_jpeg(nm)]
        imgs = np.zeros((len(raw), image_size, image_size, 3), np.uint8)
        ok = np.zeros(len(raw), bool)
        if jpeg_items:
            dec, okj = jpeg_decode_resize([r for _, r in jpeg_items],
                                          image_size, image_size)
            for (i, _), d, o in zip(jpeg_items, dec, okj):
                imgs[i], ok[i] = d, o
        for i, (r, nm) in enumerate(zip(raw, names)):
            if not _is_jpeg(nm):
                try:
                    from PIL import Image
                    im = Image.open(io.BytesIO(r)).convert("RGB") \
                        .resize((image_size, image_size))
                    imgs[i], ok[i] = np.asarray(im, np.uint8), True
                except Exception:
                    ok[i] = False
        keys = [nm.rsplit(".", 1)[0] for nm in names]
        good = np.where(ok)[0]
        return imgs[good], [keys[i] for i in good], \
            [texts.get(keys[i], "") for i in good]

    for path in paths:
        try:
            index = tar_index(path)
        except IOError:
            log.warning("skipping unreadable tar %s", path)
            continue
        # collect texts first (txt members), then stream image batches
        txt_entries = [(nm, off, sz) for nm, off, sz in index
                       if nm.lower().endswith(".txt")]
        if txt_entries:
            raws = tar_read_batch(path, [(off, sz) for _, off, sz in txt_entries])
            for (nm, _, _), r in zip(txt_entries, raws):
                texts[nm.rsplit(".", 1)[0]] = r.decode("utf-8", "replace")
        img_entries = [(nm, off, sz) for nm, off, sz in index
                       if nm.lower().endswith(tuple(suffixes))]
        for i in range(0, len(img_entries), batch_size):
            chunk = [(path, (off, sz), nm)
                     for nm, off, sz in img_entries[i:i + batch_size]]
            yield flush(path, chunk)
