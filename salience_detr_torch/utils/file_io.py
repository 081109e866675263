"""File IO behind one interface (the port's own copy of
salience_detr_tpu/utils/file_io.py, the reference's iopath ``PathManager``
role): local paths, plus scheme handlers registered by prefix.

A ``gs://`` handler through TensorFlow's ``gfile`` is registered where
TensorFlow is installed; it imports TensorFlow at its first use, not when
this module is imported (an import of TensorFlow takes seconds)."""

from __future__ import annotations

import importlib.util
import os
import shutil
from typing import IO, Dict, List


class PathManager:
    _handlers: Dict[str, "PathHandler"] = {}

    @classmethod
    def register_handler(cls, handler: "PathHandler"):
        for prefix in handler.prefixes:
            cls._handlers[prefix] = handler

    @classmethod
    def _handler(cls, path: str):
        for prefix, h in cls._handlers.items():
            if path.startswith(prefix):
                return h
        return None

    @classmethod
    def open(cls, path: str, mode: str = "r") -> IO:
        h = cls._handler(path)
        return h.open(path, mode) if h else open(path, mode)

    @classmethod
    def exists(cls, path: str) -> bool:
        h = cls._handler(path)
        return h.exists(path) if h else os.path.exists(path)

    @classmethod
    def ls(cls, path: str) -> List[str]:
        h = cls._handler(path)
        return h.ls(path) if h else sorted(os.listdir(path))

    @classmethod
    def mkdirs(cls, path: str):
        h = cls._handler(path)
        if h:
            h.mkdirs(path)
        else:
            os.makedirs(path, exist_ok=True)

    @classmethod
    def copy(cls, src: str, dst: str):
        h = cls._handler(src) or cls._handler(dst)
        if h:
            h.copy(src, dst)
        else:
            shutil.copy2(src, dst)


class PathHandler:
    prefixes: tuple = ()

    def open(self, path: str, mode: str) -> IO:  # pragma: no cover
        raise NotImplementedError

    def exists(self, path: str) -> bool:  # pragma: no cover
        raise NotImplementedError

    def ls(self, path: str) -> List[str]:  # pragma: no cover
        raise NotImplementedError

    def mkdirs(self, path: str):  # pragma: no cover
        raise NotImplementedError

    def copy(self, src: str, dst: str):  # pragma: no cover
        raise NotImplementedError


class _GFileHandler(PathHandler):
    """``gs://`` paths through ``tensorflow.io.gfile``, imported at first use."""

    prefixes = ("gs://",)

    @staticmethod
    def _gfile():
        from tensorflow.io import gfile  # type: ignore

        return gfile

    def open(self, path, mode):
        return self._gfile().GFile(path, mode)

    def exists(self, path):
        return self._gfile().exists(path)

    def ls(self, path):
        return sorted(self._gfile().listdir(path))

    def mkdirs(self, path):
        self._gfile().makedirs(path)

    def copy(self, src, dst):
        self._gfile().copy(src, dst, overwrite=True)


if importlib.util.find_spec("tensorflow") is not None:
    PathManager.register_handler(_GFileHandler())
