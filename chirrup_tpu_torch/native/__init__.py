"""Native (C) host components, built with the system C compiler at first use.

`trie_tokenizer()` compiles `trie_tokenizer.c` against this interpreter's
headers into `native/build/` (not next to the sources; the directory is not
committed) under a name that carries a hash of the source and the
interpreter's extension suffix, so a changed source or another Python
builds anew. The build writes a temporary file and renames it into place,
so processes that build at once never load a half-written library.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")

_loaded: dict = {}


def _build(name: str) -> str:
    src = os.path.join(_DIR, f"{name}.c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + suffix.encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}_{digest}{suffix}")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def trie_tokenizer():
    """The compiled `trie_tokenizer` module (built on the first call; raises
    when the compiler or the interpreter's headers are missing)."""
    if "trie_tokenizer" not in _loaded:
        path = _build("trie_tokenizer")
        spec = importlib.util.spec_from_file_location("trie_tokenizer", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded["trie_tokenizer"] = mod
    return _loaded["trie_tokenizer"]
