"""Pulse-profile template ``.txt`` files (read/write).

The port's own copy of ``crimp_tpu/io/template.py`` (numpy only).

Format parity with the reference (writer pulseprofile.py:719-748, reader
readPPtemplate.py:15-166): a ``model`` line (fourier|vonmises|cauchy), a
``norm`` line, per-component ``amp_k`` + (``ph_k`` | ``cen_k``,``wid_k``)
lines each carrying a ``vary True|False`` flag, then chi2/dof/redchi2.

The parsed dictionary uses the same shape as the reference:
``{'model': str, 'nbrComp': int, 'norm': {'value','vary'},
   'amp_1': {...}, ...}``.
"""

from __future__ import annotations

import re

import numpy as np

_PARAM_RE = re.compile(r"^(norm|amp_\d+|ph_\d+|cen_\d+|wid_\d+)$")


def read_template(path: str) -> dict:
    """Parse a template .txt into a parameter dictionary."""
    model = None
    params: dict = {}
    stats: dict = {}
    with open(path, "r") as fh:
        for raw in fh:
            tokens = raw.split()
            if not tokens:
                continue
            key = tokens[0]
            if key == "model" and len(tokens) >= 2:
                model = tokens[1]
            elif _PARAM_RE.match(key) and len(tokens) >= 2:
                entry = {"value": np.float64(tokens[1])}
                if len(tokens) >= 4 and tokens[2] == "vary":
                    entry["vary"] = tokens[3].lower() == "true"
                else:
                    entry["vary"] = True
                params[key] = entry
            elif key in ("chi2", "dof", "redchi2") and len(tokens) >= 2:
                stats[key] = float(tokens[1])

    if model is None:
        raise ValueError(f'template file {path!r} has no "model" line')
    model_cf = model.casefold()
    if model_cf not in ("fourier", "vonmises", "cauchy"):
        raise ValueError(
            f"model {model!r} is not supported; fourier, vonmises, cauchy are supported"
        )
    if "norm" not in params:
        raise ValueError(f'template file {path!r} has no "norm" line')

    comp_ids = [int(k.split("_")[1]) for k in params if k.startswith("amp_")]
    if not comp_ids:
        raise ValueError(f"template file {path!r} has no amp_k components")
    nbr_comp = max(comp_ids)

    required = ["amp_1", "ph_1"] if model_cf == "fourier" else ["amp_1", "cen_1", "wid_1"]
    for key in required:
        if key not in params:
            raise ValueError(f"template file {path!r} is missing {key!r}")

    out = {"model": model_cf, "nbrComp": nbr_comp, **params}
    out.update(stats)
    return out


def write_template(path_stem: str, fit_results: dict) -> str:
    """Write best-fit template parameters to ``<path_stem>.txt``.

    ``fit_results`` holds flat values: model, norm, amp_k, ph_k|cen_k/wid_k,
    chi2, dof, redchi2 (as produced by the template-fit pipeline).
    """
    model = str(fit_results["model"]).casefold()
    comp_ids = sorted(
        int(k.split("_")[1]) for k in fit_results if k.startswith("amp_")
    )
    path = path_stem + ".txt"
    with open(path, "w") as fh:
        fh.write(f"model {fit_results['model']}\n")
        fh.write(f"norm {fit_results['norm']} vary True \n")
        for k in comp_ids:
            fh.write(f"amp_{k} {fit_results[f'amp_{k}']} vary True \n")
            if model == "fourier":
                fh.write(f"ph_{k} {fit_results[f'ph_{k}']} vary True \n")
            else:
                fh.write(f"cen_{k} {fit_results[f'cen_{k}']} vary True \n")
                fh.write(f"wid_{k} {fit_results[f'wid_{k}']} vary True \n")
        fh.write(f"chi2 {fit_results['chi2']}\n")
        fh.write(f"dof {fit_results['dof']}\n")
        fh.write(f"redchi2 {fit_results['redchi2']}\n")
    return path


# Reference-named alias, as in the JAX package.
readPPtemplate = read_template
