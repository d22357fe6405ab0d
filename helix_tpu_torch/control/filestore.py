"""Filestore: a rooted local blob store with per-owner prefixes.

The port's copy of the blob half of ``helix_tpu/control/filestore.py``
(``Filestore``): the same root, owner and path checks (``_resolve``), the
same layout on disk and the same ``.signing-secret`` key file, so a
reference runner and a port runner can share one directory.  Signed
download URLs are control-plane code and stay in the reference.

One difference: ``write`` lands a blob through a temporary name in the
same directory and ``os.replace``, so a reader never sees a partly
written file (the reference writes the final path in place; a reader
that arrives mid-write reads a short blob).  The final path and bytes
are the reference's.
"""

from __future__ import annotations

import os
import secrets
import shutil


def load_or_create_keyfile(path: str, nbytes: int = 32) -> bytes:
    """Read a secret key file, creating it atomically if absent (the
    reference's ``helix_tpu.utils.load_or_create_keyfile``): a 0600
    temporary file hard-linked into place, so a process that loses the
    race re-reads the winner's key; a truncated file is replaced."""
    for _ in range(20):
        truncated = False
        try:
            with open(path, "rb") as f:
                key = f.read()
            if len(key) >= nbytes:
                return key
            truncated = True
        except FileNotFoundError:
            pass
        key = secrets.token_bytes(nbytes)
        tmp = f"{path}.tmp.{os.getpid()}.{secrets.token_hex(4)}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key)
        if truncated:
            os.rename(tmp, path)
        else:
            try:
                os.link(tmp, path)
            except FileExistsError:
                pass   # lost the race: the loop re-reads the winner's key
            os.unlink(tmp)
    raise RuntimeError(f"could not create or read key file {path}")


class Filestore:
    def __init__(self, root: str, secret: bytes | None = None):
        self.root = os.path.realpath(root)
        os.makedirs(self.root, exist_ok=True)
        if secret is None:
            secret = load_or_create_keyfile(
                os.path.join(self.root, ".signing-secret"))
        self._secret = secret

    def _resolve(self, owner: str, path: str) -> str:
        if (
            not owner
            or owner.startswith(".")   # reserves dotfiles (.signing-secret)
            or "/" in owner
            or os.sep in owner
            or ".." in owner
        ):
            raise PermissionError("invalid owner id")
        base = os.path.realpath(os.path.join(self.root, owner))
        # separator-terminated prefixes: '../ownerX' must not pass as a
        # sibling whose name extends the owner id
        if base != self.root and not base.startswith(self.root + os.sep):
            raise PermissionError("owner escapes the filestore")
        p = os.path.realpath(os.path.join(base, path.lstrip("/")))
        if p != base and not p.startswith(base + os.sep):
            raise PermissionError("path escapes the filestore")
        return p

    def write(self, owner: str, path: str, data: bytes) -> dict:
        """Store ``data`` at ``path``: written under a temporary name in
        the same directory, then renamed over the final path."""
        p = self._resolve(owner, path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}.{secrets.token_hex(4)}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.stat(owner, path)

    def read(self, owner: str, path: str) -> bytes:
        with open(self._resolve(owner, path), "rb") as f:
            return f.read()

    def stat(self, owner: str, path: str) -> dict:
        p = self._resolve(owner, path)
        st = os.stat(p)
        return {
            "path": path.lstrip("/"),
            "size": st.st_size,
            "modified": st.st_mtime,
            "is_dir": os.path.isdir(p),
        }

    def list(self, owner: str, path: str = "") -> list:
        p = self._resolve(owner, path or ".")
        if not os.path.isdir(p):
            return []
        return [self.stat(owner, os.path.join(path, name))
                for name in sorted(os.listdir(p))]

    def delete(self, owner: str, path: str) -> bool:
        p = self._resolve(owner, path)
        if os.path.isdir(p):
            shutil.rmtree(p)
            return True
        if os.path.exists(p):
            os.remove(p)
            return True
        return False
