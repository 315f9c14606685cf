"""Offline dataset staging: the `Module2/util/get_data.py` equivalent.
Port of ``animateportrait_tpu/utils/get_data.py`` (stdlib only; the port
keeps its own copy, as it imports nothing of the JAX package).

The reference ships a `GetData` helper that downloads + extracts
CycleGAN/pix2pix dataset archives and returns the staged path
(`get_data.py:11-110`). This environment has no egress, and this
framework's datasets are the readme's tarballs (readme.md:57-59), so
the TPU-native equivalent stages *local* archives instead: list the
archives in a source directory, extract the chosen one under
``save_path``, and validate the resulting tree against the UMLVD-IFW
layout that `data/umlvd_ifw.py` consumes.
"""
from __future__ import annotations

import os
import tarfile
from zipfile import ZipFile

# subdirectories data/umlvd_ifw.py reads (drawing config; the cartoon
# twin swaps Drawing -> Cartoon)
UMLVD_LAYOUT = ("Photo", "Alm/MTCNN", "Alm_txt/MTCNN")
UMLVD_OPTIONAL = ("Drawing", "Cartoon", "Amask", "Bmask", "fakeB_static",
                  "Blm/MTCNN", "Blm_txt/MTCNN")

ARCHIVE_EXTS = (".tar.gz", ".tgz", ".tar", ".zip")


class GetData:
    """List and stage local dataset archives (offline `GetData`).

    >>> gd = GetData(source_dir='/data/archives')
    >>> gd.options()                       # available archive names
    >>> path = gd.get('umlvd.tar.gz', save_path='./datasets')
    """

    def __init__(self, source_dir: str, verbose: bool = True):
        self.source_dir = source_dir
        self._verbose = verbose

    def _print(self, text: str) -> None:
        if self._verbose:
            print(text)

    def options(self) -> list[str]:
        """Archive files available in ``source_dir``."""
        if not os.path.isdir(self.source_dir):
            return []
        return sorted(f for f in os.listdir(self.source_dir)
                      if f.endswith(ARCHIVE_EXTS))

    @staticmethod
    def _check_member(name: str, dest_real: str) -> None:
        # refuse traversal outside dest: commonpath, not startswith —
        # "../datasets_evil/x" under dest ".../datasets" passes a bare
        # prefix check but escapes into a sibling directory
        target = os.path.realpath(os.path.join(dest_real, name))
        if os.path.commonpath([target, dest_real]) != dest_real:
            raise ValueError(f"unsafe archive member {name!r}")

    @classmethod
    def _extract(cls, archive: str, dest: str) -> None:
        dest_real = os.path.realpath(dest)
        if archive.endswith(".zip"):
            with ZipFile(archive) as zf:
                for name in zf.namelist():
                    cls._check_member(name, dest_real)
                zf.extractall(dest)
        else:
            with tarfile.open(archive) as tf:
                try:
                    tf.extractall(dest, filter="data")
                except TypeError:  # py<3.12 without the filter kwarg
                    members = tf.getmembers()
                    for m in members:
                        cls._check_member(m.name, dest_real)
                        # a symlink member pointing outside dest could
                        # redirect a later member's extraction
                        if m.issym() or m.islnk():
                            base = os.path.dirname(
                                os.path.join(dest_real, m.name))
                            cls._check_member(
                                os.path.join(base, m.linkname), dest_real)
                    tf.extractall(dest, members=members)

    def get(self, name: str | None = None,
            save_path: str = "./datasets") -> str:
        """Extract archive ``name`` (the only available one when None)
        into ``save_path`` and return the staged dataset root."""
        opts = self.options()
        if name is None:
            if len(opts) != 1:
                raise ValueError(
                    f"specify one of {opts} (source: {self.source_dir})")
            name = opts[0]
        if name not in opts:
            raise FileNotFoundError(
                f"{name!r} not in {self.source_dir} (have {opts})")
        os.makedirs(save_path, exist_ok=True)
        self._print(f"extracting {name} -> {save_path}")
        self._extract(os.path.join(self.source_dir, name), save_path)
        base = name
        for ext in ARCHIVE_EXTS:
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        root = os.path.join(save_path, base)
        out = root if os.path.isdir(root) else save_path
        self._print(f"staged at {out}")
        return out


def validate_umlvd_layout(root: str,
                          style_dir: str = "Drawing") -> list[str]:
    """Return the list of REQUIRED subdirectories missing from a staged
    UMLVD-IFW dataset root (empty list = valid). Required = the photo
    side plus the requested style side; masks/clips/fakeB_static are
    model-flag dependent and only warned about by callers."""
    required = list(UMLVD_LAYOUT) + [style_dir]
    return [d for d in required
            if not os.path.isdir(os.path.join(root, d))]
