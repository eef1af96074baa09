"""Raw-frame sidecar cache: decode each PNG once, then memmap forever
(crfp_tpu/data/cache.py; the same key and file layout).

REDS training reads 15-frame sliding windows, so every frame is re-decoded
up to 15 times per epoch by the reference pipeline (PIL PNG inflate is the
dominant host cost at 720p+). This cache converts a clip directory to one
contiguous uint8 .npy file on first touch; subsequent reads are zero-copy
memmap slices served from the page cache. This is the same idea as the
LMDB preprocessing used by EDVR/mmediting pipelines, without the LMDB
dependency.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np
import PIL.Image


class FrameCache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._maps: dict[str, tuple[np.memmap, dict]] = {}
        self._lock = threading.Lock()

    # memmaps/locks cannot cross process boundaries: process-pool loader
    # workers re-open them lazily after unpickling
    def __getstate__(self):
        return {"cache_dir": self.cache_dir}

    def __setstate__(self, state):
        self.cache_dir = state["cache_dir"]
        self._maps = {}
        self._lock = threading.Lock()

    def _clip_key(self, clip_dir: str) -> str:
        return hashlib.sha1(os.path.abspath(clip_dir).encode()).hexdigest()[:16]

    def _build(self, clip_dir: str, raw_path: str, meta_path: str) -> None:
        files = sorted(f for f in os.listdir(clip_dir) if f.endswith(".png"))
        first = np.array(PIL.Image.open(os.path.join(clip_dir, files[0])))
        h, w, c = first.shape
        tmp = raw_path + ".tmp"
        mm = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.uint8, shape=(len(files), h, w, c)
        )
        mm[0] = first
        for i, f in enumerate(files[1:], start=1):
            mm[i] = np.array(PIL.Image.open(os.path.join(clip_dir, f)))
        mm.flush()
        del mm
        os.replace(tmp, raw_path)
        with open(meta_path, "w") as f:
            json.dump({"files": files, "shape": [len(files), h, w, c]}, f)

    def _get_clip(self, clip_dir: str):
        key = self._clip_key(clip_dir)
        with self._lock:
            hit = self._maps.get(key)
        if hit is not None:
            return hit
        raw_path = os.path.join(self.cache_dir, key + ".npy")
        meta_path = os.path.join(self.cache_dir, key + ".json")
        with self._lock:
            if key not in self._maps:
                if not (os.path.exists(raw_path) and os.path.exists(meta_path)):
                    self._build(clip_dir, raw_path, meta_path)
                with open(meta_path) as f:
                    meta = json.load(f)
                mm = np.load(raw_path, mmap_mode="r")
                meta["index"] = {name: i for i, name in enumerate(meta["files"])}
                self._maps[key] = (mm, meta)
            return self._maps[key]

    def load_window(
        self, paths: list[str], crop: tuple[int, int, int, int] | None = None
    ) -> np.ndarray:
        """paths: PNG files (typically consecutive frames of one clip).
        crop: optional (y0, y1, x0, x1) applied INSIDE the memmap read so
        only the cropped pages are touched/copied.
        Returns a (T, h, w, C) uint8 array."""
        out = []
        for p in paths:
            clip_dir = os.path.dirname(p)
            mm, meta = self._get_clip(clip_dir)
            frame = mm[meta["index"][os.path.basename(p)]]
            if crop is not None:
                y0, y1, x0, x1 = crop
                frame = frame[y0:y1, x0:x1]
            out.append(frame)
        return np.stack(out)

    def frame_shape(self, path: str) -> tuple[int, int, int]:
        mm, _ = self._get_clip(os.path.dirname(path))
        return tuple(mm.shape[1:])
