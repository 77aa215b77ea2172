"""Crash-safe incremental JSON result persistence (counterpart of
``ldpc_decoders_tpu.harness.saver``; same schema, file name and bytes).

The file is named by the joined run-id values. Every ``add`` merges the new
per-parameter values into the file's document and rewrites the whole file
through a temp file and a rename, so a killed run keeps every completed log
tick, and results accumulate across runs and processes into one file.

A ``Saver`` holds the document it last wrote, each entry kept as the
bytes ``json.dump(..., indent=4)`` writes for it, and the file's
``(st_ino, st_size, st_mtime_ns)`` as it renamed it into place. An ``add``
that finds the file as it left it encodes only the values it sets and
joins the rest; one that finds the file changed or gone (another writer)
reloads and merges it as the JAX package's ``Saver`` does, and counts
``saver_reloads``. Either way the file holds the bytes that reload, merge
and ``json.dump`` would write."""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from json.encoder import encode_basestring_ascii

from ldpc_decoders_tpu_torch.utils import profiler
from ldpc_decoders_tpu_torch.utils.file import load_json, make_dir_if_not_exists

INDENT = " " * 4
# The stdlib's C encoder: for a scalar the same text as the indented
# (pure-Python) encoder, ``float.__repr__`` and ``NaN`` / ``Infinity``
# included.
_encode = json.JSONEncoder().encode


def _key(key) -> str:
    """A key as JSON writes it: a number, bool or None key as its text."""
    if isinstance(key, str):
        return key
    if isinstance(key, (int, float)) or key is None:
        return _encode(key)
    raise TypeError(f"keys must be str, int, float, bool or None, "
                    f"not {type(key).__name__}")


def _value(value, ind: str) -> str:
    """``value`` as ``json.dump(indent=4)`` writes it on a line indented
    by ``ind``."""
    if isinstance(value, dict):
        if not value:
            return "{}"
        inner = ind + INDENT
        return ("{\n" + ",\n".join([_member(k, v, inner)
                                     for k, v in value.items()])
                + f"\n{ind}}}")
    if isinstance(value, (list, tuple)):
        if not value:
            return "[]"
        inner = ind + INDENT
        if any(isinstance(v, (dict, list, tuple)) for v in value):
            body = (",\n" + inner).join([_value(v, inner) for v in value])
        else:   # scalars (an iteration histogram): one call of the C encoder
            body = json.JSONEncoder(
                separators=(",\n" + inner, ": ")).encode(value)[1:-1]
        return f"[\n{inner}{body}\n{ind}]"
    return _encode(value)


def _member(key, value, ind: str) -> str:
    """The line ``"key": value`` indented by ``ind``."""
    return f"{ind}{encode_basestring_ascii(_key(key))}: {_value(value, ind)}"


def _line(key, value, ind: str) -> bytes:
    """``_member``'s line as the file's bytes (JSON text here is ASCII)."""
    return _member(key, value, ind).encode("ascii")


def _encoded(data) -> OrderedDict:
    """A document as its entries' lines: a top-level object as its
    members' lines by key, any other value as its line."""
    doc = OrderedDict()
    for k, v in data.items():
        if isinstance(v, dict):
            doc[_key(k)] = OrderedDict((_key(p), _line(p, x, 2 * INDENT))
                                       for p, x in v.items())
        else:
            doc[_key(k)] = _line(k, v, INDENT)
    return doc


def _text(doc) -> bytes:
    """``json.dump(data, fp, indent=4)``'s bytes from ``_encoded(data)``,
    joined once."""
    if not doc:
        return b"{}"
    out = []
    for k, e in doc.items():
        out.append(b",\n" if out else b"{\n")
        if isinstance(e, bytes):
            out.append(e)
            continue
        head = f"{INDENT}{encode_basestring_ascii(k)}: {{".encode("ascii")
        if not e:
            out.append(head + b"}")
            continue
        out.append(head)
        sep = b"\n"
        for line in e.values():
            out += (sep, line)
            sep = b",\n"
        out.append(f"\n{INDENT}}}".encode("ascii"))
    out.append(b"\n}")
    return b"".join(out)


def _file_stamp(st: os.stat_result) -> tuple:
    return st.st_ino, st.st_size, st.st_mtime_ns


class Saver:
    def __init__(self, data_dir: str, run_ids):
        self.dict = OrderedDict(run_ids)
        make_dir_if_not_exists(data_dir)
        file_name = "-".join(str(v) for v in self.dict.values())
        self.file_path = os.path.join(data_dir, f"{file_name}.json")
        self._doc = None     # the document last written, encoded
        self._stamp = None   # its file's stamp; None: reload at next add

    def add(self, param, val_dict) -> None:
        with profiler.span("saver"):
            doc = self._doc if self._unchanged() else self._load(val_dict)
            self._stamp = None   # until the merged document is written
            p = str(param)
            for key, val in val_dict.items():
                doc.setdefault(_key(key), OrderedDict())[p] = _line(
                    p, val, 2 * INDENT)
            self._write(doc)

    def add_all(self, val_dict) -> None:
        """Rewrite the file as the run ids plus ``val_dict`` (the LT CLI's
        whole ``arr`` after every batch)."""
        data = OrderedDict(self.dict)
        data.update(val_dict)
        self._stamp = None
        self._doc = _encoded(data)
        self._write(self._doc)

    def _unchanged(self) -> bool:
        """Whether the file is the one this Saver last renamed into place."""
        if self._stamp is None:
            return False
        try:
            return _file_stamp(os.stat(self.file_path)) == self._stamp
        except OSError:
            return False

    def _load(self, val_dict) -> OrderedDict:
        """The file's document, or the run ids and an empty object per key
        of ``val_dict`` where it is missing or unreadable."""
        profiler.count("saver_reloads")
        data = load_json(self.file_path)
        if data is None:
            data = OrderedDict(self.dict)
            for key in val_dict:
                data[key] = {}
        self._doc = _encoded(data)
        return self._doc

    def _write(self, doc) -> None:
        # Atomic: a kill mid-write leaves the previous file whole.
        text = _text(doc)
        tmp_path = self.file_path + ".tmp"
        with profiler.span("saver.write"):
            with open(tmp_path, "wb") as fp:
                fp.write(text)
                fp.flush()
                st = os.fstat(fp.fileno())
            os.replace(tmp_path, self.file_path)
        self._stamp = _file_stamp(st)
