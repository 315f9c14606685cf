"""Menpo-free reader of the reference's shipped PDM/CLM shape models: the
port's own copy of ``animateportrait_tpu/io/menpo_pickle.py`` (numpy only;
the port imports nothing of the JAX package).

The reference ships trained menpofit ``OrthoPDM`` / ``CLM`` pickles under
``Module1/thirdparty/face_of_art/pdm_clm_models/{pdm_models,clm_models}``
and consumes them in ``pdm_clm_functions.py:124-203``. This module unpickles
them with stub classes and extracts the numerical payload:

- ``PCAModel``: ``_mean`` (2P,), ``_components`` (n_pc, 2P) orthonormal
  rows, ``_eigenvalues``;
- ``_SimilarityModel``: the 4-row linearized-similarity basis of the mean
  shape (so menpo's ``set_target`` is a one-shot projection);
- the stored fitting state (``_target``, ``_weights``,
  ``similarity_weights``): ``mean + sim_basisᵀ·sim_w + shape_basisᵀ·w``
  reproduces ``_target`` (tests/test_torch_face_of_art.py checks it on
  pickles of menpo-named stub classes that the test writes).
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

__all__ = [
    "MenpoStub", "load_menpo_pickle", "ReferencePDM",
    "load_reference_pdm", "load_reference_part_pdms",
    "load_reference_clm",
]


class MenpoStub:
    """Attribute bag standing in for any menpo/menpofit class."""

    def __init__(self, *args, **kwargs):
        # some pickled members (e.g. pathlib.PosixPath) are rebuilt with
        # constructor args; keep them for inspection, nothing reads them
        if args:
            self.__dict__["_args"] = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {sorted(self.__dict__)}>"


_STUB_CACHE: dict = {}


def _make_stub(module: str, name: str) -> type:
    key = f"{module}.{name}"
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (MenpoStub,), {"_module": module})
    return _STUB_CACHE[key]


def _reconstructor(cls, base, state):
    # copy_reg._reconstructor for old-protocol pickles: we only need the
    # instance shell; __setstate__ fills it in.
    return cls.__new__(cls)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "copy_reg" and name == "_reconstructor":
            return _reconstructor
        if (module.startswith(("menpo", "menpofit"))
                or module == "__builtin__"):
            if name == "object":
                return object
            return _make_stub(module, name)
        if module == "pathlib":
            # reference_shape.path points at the author's laptop; not data
            return _make_stub(module, name)
        return super().find_class(module, name)


def load_menpo_pickle(path: str):
    """Unpickle a menpo/menpofit file (py2 or py3 protocol) into stubs."""
    with open(path, "rb") as f:
        try:
            return _Unpickler(f).load()
        except UnicodeDecodeError:
            f.seek(0)
            return _Unpickler(f, fix_imports=True,
                              encoding="latin1").load()


@dataclasses.dataclass(frozen=True)
class ReferencePDM:
    """Numerical payload of a menpofit OrthoPDM.

    ``basis`` stacks the 4 linearized-similarity rows above the active
    shape-PC rows; the joint set is orthonormal, so menpo's
    ``set_target`` (pdm_correct, pdm_clm_functions.py:83-88) is exactly
    ``mean + basisᵀ · (basis · (x − mean))``.
    """

    mean: np.ndarray          # (2P,) flattened (y, x) mean shape
    basis: np.ndarray         # (4 + n_pc, 2P) orthonormal rows
    eigenvalues: np.ndarray   # (n_pc,) active shape eigenvalues
    n_sim: int = 4
    # stored fitting state from the pickle (parity-test ground truth)
    stored_target: np.ndarray | None = None    # (P, 2)
    stored_weights: np.ndarray | None = None   # (n_pc_total,)
    stored_sim_weights: np.ndarray | None = None  # (4,)

    @property
    def n_points(self) -> int:
        return self.mean.size // 2

    @property
    def n_shape(self) -> int:
        return self.basis.shape[0] - self.n_sim


def _pdm_from_stub(pdm, n_active: int | None = None) -> ReferencePDM:
    mean = np.asarray(pdm.model._mean, np.float64)
    comps = np.asarray(pdm.model._components, np.float64)
    eigs = np.asarray(pdm.model._eigenvalues, np.float64)
    if n_active is None:
        n_active = int(getattr(pdm.model, "_n_active_components",
                               comps.shape[0]))
    comps = comps[:n_active]
    eigs = eigs[:n_active]
    sim = np.asarray(pdm.similarity_model._components, np.float64)
    return ReferencePDM(
        mean=mean,
        basis=np.vstack([sim, comps]),
        eigenvalues=eigs,
        n_sim=sim.shape[0],
        stored_target=np.asarray(pdm._target.points, np.float64),
        stored_weights=np.asarray(pdm._weights, np.float64),
        stored_sim_weights=np.asarray(pdm.similarity_weights, np.float64),
    )


def load_reference_pdm(path: str,
                       n_active: int | None = None) -> ReferencePDM:
    """Load one ``pdm_models/<train_type>_<part>_<pc>`` file."""
    return _pdm_from_stub(load_menpo_pickle(path), n_active)


# selected PC count per part (pdm_clm_functions.py:139-153)
_PART_PCS = {"l_brow": 2, "r_brow": 2, "l_eye": 3, "r_eye": 3,
             "mouth": 7, "nose": 5, "jaw": 7}


def load_reference_part_pdms(models_dir: str, train_type: str = "basic"
                             ) -> dict[str, ReferencePDM]:
    """Load the 7 per-part PDMs used by ``feature_based_pdm_corr``
    (pdm_clm_functions.py:124-170): ``<train_type>_<part>_<pc>``."""
    out = {}
    for part, pc in _PART_PCS.items():
        path = os.path.join(models_dir, f"{train_type}_{part}_{pc}")
        out[part] = load_reference_pdm(path)
    return out


def load_reference_clm(path: str, n_shape: int = 30
                       ) -> tuple[ReferencePDM, dict]:
    """Load a ``clm_models/<train_type>_all`` file.

    Returns the single-scale shape model with ``n_shape`` active
    components (``GradientDescentCLMFitter(part_model, n_shape=30)``,
    pdm_clm_functions.py:196) and the pickle's stored ECT options dict
    (numIter/kernel_covariance/rho2/... as overwritten at :183-194).
    """
    clm = load_menpo_pickle(path)
    pdm = _pdm_from_stub(clm.shape_models[0], n_active=n_shape)
    opt = dict(getattr(clm, "opt", {}) or {})
    # clm_correct overwrites these before fitting (:183-194)
    opt.update(numIter=5, kernel_covariance=10, sigOffset=25,
               sigRate=0.25, pdm_rho=20, verbose=False, rho2=20,
               ablation=(True, True), ratio1=0.12, ratio2=0.08,
               smooth=True)
    return pdm, opt
