"""The port's offline dataset staging (``utils/get_data.py``) against the
JAX package's, on the same archives: the same listing, the same staged
root and files, the same layout report, and each refusal case of
``tests/test_get_data.py`` refused by both, with nothing written outside
the destination."""
import io
import os
import tarfile
from zipfile import ZipFile

import pytest

from animateportrait_tpu.utils import get_data as jgd
from animateportrait_tpu_torch.utils import get_data as tgd

PACKAGES = {"jax": jgd, "port": tgd}


def _make_archive(tmp_path, name="umlvd.tar.gz"):
    src = tmp_path / "stage" / "umlvd"
    for d in ("Photo", "Alm/MTCNN", "Alm_txt/MTCNN", "Drawing"):
        (src / d).mkdir(parents=True)
        (src / d / "a.txt").write_bytes(b"0")
    (src / "Photo" / "a.png").write_bytes(b"x")
    arch_dir = tmp_path / "archives"
    arch_dir.mkdir()
    with tarfile.open(arch_dir / name, "w:gz") as tf:
        tf.add(src, arcname="umlvd")
    with ZipFile(arch_dir / "umlvd_zip.zip", "w") as zf:
        for root, _, files in os.walk(src):
            for f in files:
                p = os.path.join(root, f)
                zf.write(p, arcname=os.path.join(
                    "umlvd_zip", os.path.relpath(p, src)))
    return str(arch_dir)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", ["umlvd.tar.gz", "umlvd_zip.zip"])
def test_options_get_and_layout_match_jax(tmp_path, name):
    arch_dir = _make_archive(tmp_path)
    staged = {}
    for key, mod in PACKAGES.items():
        gd = mod.GetData(arch_dir, verbose=False)
        assert gd.options() == ["umlvd.tar.gz", "umlvd_zip.zip"]
        root = gd.get(name, save_path=str(tmp_path / key))
        staged[key] = (os.path.relpath(root, str(tmp_path / key)),
                       _tree(root), mod.validate_umlvd_layout(root),
                       mod.validate_umlvd_layout(root, "Cartoon"))
    assert staged["port"] == staged["jax"]
    assert staged["port"][2] == [] and staged["port"][3] == ["Cartoon"]
    assert tgd.UMLVD_LAYOUT == jgd.UMLVD_LAYOUT
    assert tgd.UMLVD_OPTIONAL == jgd.UMLVD_OPTIONAL
    assert tgd.ARCHIVE_EXTS == jgd.ARCHIVE_EXTS


def test_get_unknown_name_and_ambiguous_default(tmp_path):
    arch_dir = _make_archive(tmp_path)
    for mod in PACKAGES.values():
        gd = mod.GetData(arch_dir, verbose=False)
        with pytest.raises(FileNotFoundError):
            gd.get("nope.tar.gz", save_path=str(tmp_path / "d"))
        with pytest.raises(ValueError, match="specify one of"):
            gd.get(save_path=str(tmp_path / "d"))
        assert mod.GetData(str(tmp_path / "none")).options() == []


def test_validate_reports_missing(tmp_path):
    root = tmp_path / "bad"
    (root / "Photo").mkdir(parents=True)
    assert tgd.validate_umlvd_layout(str(root)) == \
        jgd.validate_umlvd_layout(str(root)) == [
            "Alm/MTCNN", "Alm_txt/MTCNN", "Drawing"]


def _evil_tar(arch_dir, tmp_path):
    evil = tmp_path / "evil.txt"
    evil.write_text("evil")
    with tarfile.open(arch_dir / "evil.tar", "w") as tf:
        tf.add(evil, arcname="../evil_escape.txt")
    return "evil.tar", [tmp_path / "evil_escape.txt"]


def _sibling(arch_dir, tmp_path, kind):
    payload = tmp_path / "p.txt"
    payload.write_text("x")
    if kind == "tar":
        with tarfile.open(arch_dir / "sib.tar", "w") as tf:
            tf.add(payload, arcname="../out_evil/p.txt")
    else:
        with ZipFile(arch_dir / "sib.zip", "w") as zf:
            zf.write(payload, arcname="../out_evil/p.txt")
    return f"sib.{kind}", [tmp_path / "out_evil"]


def _symlink(arch_dir, tmp_path):
    with tarfile.open(arch_dir / "link.tar", "w") as tf:
        m = tarfile.TarInfo("escape")
        m.type = tarfile.SYMTYPE
        m.linkname = "../../outside"
        tf.addfile(m)
        payload = tarfile.TarInfo("escape/p.txt")
        payload.size = 1
        tf.addfile(payload, io.BytesIO(b"x"))
    return "link.tar", [tmp_path / "outside"]


CASES = {
    "tar_traversal": _evil_tar,
    "tar_sibling": lambda a, t: _sibling(a, t, "tar"),
    "zip_sibling": lambda a, t: _sibling(a, t, "zip"),
    "tar_symlink": _symlink,
}


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("package", list(PACKAGES))
def test_unsafe_archives_are_refused(tmp_path, monkeypatch, package, case,
                                     fallback):
    """Each refusal of ``tests/test_get_data.py``, by both packages, with
    the tar ``filter="data"`` of Python >= 3.12 and with the manual
    member checks of the fallback path (forced as the JAX test forces
    it)."""
    arch_dir = tmp_path / "archives"
    arch_dir.mkdir()
    name, outside = CASES[case](arch_dir, tmp_path)
    if fallback:
        orig = tarfile.TarFile.extractall

        def no_filter(self, path=".", members=None, **kw):
            if "filter" in kw:
                raise TypeError("no filter kwarg")
            return orig(self, path=path, members=members)

        monkeypatch.setattr(tarfile.TarFile, "extractall", no_filter)
    gd = PACKAGES[package].GetData(str(arch_dir), verbose=False)
    with pytest.raises(Exception):
        gd.get(name, save_path=str(tmp_path / "out"))
    for p in outside:
        assert not p.exists()
