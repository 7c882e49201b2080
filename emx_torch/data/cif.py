"""Crystal-structure (CIF) corpus tooling (copy of emx/data/cif.py: pure
Python).

Clean-room rebuild of the reference's crystal-structure side project
(misc_py/download_cifs.py:1-34, download_cifs_no_H.py:1-78,
copy_no_H.py:1-30): fetch CIF files from a COD URL selection, filter out
structures containing hydrogen (light atoms are invisible to the
simulated TEM contrast the files feed), and stage felix simulation job
directories pairing each structure with input templates.

Offline-first: parsing/filtering/staging need no network; `fetch_cifs`
takes an injectable `opener` so it is testable (and gated) in zero-egress
environments. The hydrogen filter actually works — the reference's loop
(`download_cifs_no_H.py:64-69`) `continue`s on hydrogen instead of
skipping the file, so it saved everything; the intent is documented in
its comments and implemented here.
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Callable, Iterable

# Minimal symbol->Z table (through Z=103, covering COD inorganics).
_ELEMENTS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In "
    "Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf "
    "Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am "
    "Cm Bk Cf Es Fm Md No Lr"
).split()
ATOMIC_NUMBER = {s: i + 1 for i, s in enumerate(_ELEMENTS)}
ATOMIC_NUMBER["D"] = 1  # deuterium counts as hydrogen (reference :25)


def element_symbol(label: str) -> str:
    """Strip ion/charge/site decorations: 'O2-' -> 'O', 'Fe3+' -> 'Fe',
    'Ca1' -> 'Ca' (reference process_elem_string:27-38)."""
    out = ""
    for c in label:
        if c.isalpha():
            out += c
        else:
            break
    # CIF type symbols are 1-2 letters, first upper. Only take the
    # 2-letter reading when the label's second character is lowercase:
    # site labels like 'HO1'/'HF2' (hydrogen sites, common when only
    # _atom_site_label is present) must resolve to H, not Ho/Hf
    # (ADVICE r2). A true 2-letter element in a CIF is written 'Ho1'.
    if (len(out) >= 2 and out[1].islower()
            and out[:2].capitalize() in ATOMIC_NUMBER):
        return out[:2].capitalize()
    return out[:1].upper()


def parse_cif(text: str) -> dict:
    """Tiny CIF reader: first data block's scalar tags plus loop_ tables.
    Returns {"tags": {name: value}, "loops": [ {headers: [...],
    rows: [[...]]} ]}. Handles quoted values and multi-line ';' fields
    well enough for COD files; not a validating parser."""
    tags: dict[str, str] = {}
    loops: list[dict] = []
    lines = text.splitlines()
    i = 0
    in_block = False
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("data_"):
            if in_block:
                break  # only the first block
            in_block = True
            i += 1
            continue
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.lower().startswith("loop_"):
            headers: list[str] = []
            i += 1
            while i < len(lines) and lines[i].strip().startswith("_"):
                headers.append(lines[i].strip().split()[0])
                i += 1
            rows: list[list[str]] = []
            while i < len(lines):
                row = lines[i].strip()
                if not row or row.startswith(("_", "loop_", "data_", "#")):
                    break
                if row.startswith(";"):  # multi-line field: swallow
                    i += 1
                    while i < len(lines) and not lines[i].startswith(";"):
                        i += 1
                    i += 1
                    continue
                vals = _split_cif_row(row)
                if len(vals) == len(headers):
                    rows.append(vals)
                i += 1
            loops.append({"headers": headers, "rows": rows})
            continue
        if line.startswith("_"):
            parts = line.split(None, 1)
            name = parts[0]
            if len(parts) == 2:
                tags[name] = parts[1].strip().strip("'\"")
            elif i + 1 < len(lines) and lines[i + 1].startswith(";"):
                i += 1
                field = []
                i += 1
                while i < len(lines) and not lines[i].startswith(";"):
                    field.append(lines[i])
                    i += 1
                tags[name] = "\n".join(field)
            i += 1
            continue
        i += 1
    return {"tags": tags, "loops": loops}


def _split_cif_row(row: str) -> list[str]:
    out, cur, quote = [], "", ""
    for c in row:
        if quote:
            if c == quote:
                quote = ""
            else:
                cur += c
        elif c in "'\"":
            quote = c
        elif c.isspace():
            if cur:
                out.append(cur)
                cur = ""
        else:
            cur += c
    if cur:
        out.append(cur)
    return out


def atom_elements(cif: dict) -> list[str]:
    """Element symbols of every atom site (prefers _atom_site_type_symbol,
    falls back to _atom_site_label)."""
    for loop in cif["loops"]:
        headers = [h.lower() for h in loop["headers"]]
        for col in ("_atom_site_type_symbol", "_atom_site_label"):
            if col in headers:
                k = headers.index(col)
                return [element_symbol(r[k]) for r in loop["rows"]]
    return []


def contains_hydrogen(cif: dict) -> bool:
    return any(ATOMIC_NUMBER.get(e) == 1 for e in atom_elements(cif))


def filter_no_h(paths: Iterable[str]) -> list[str]:
    """Hydrogen-free subset of CIF files (the download_cifs_no_H intent)."""
    keep = []
    for p in paths:
        try:
            with open(p, "r", errors="replace") as f:
                if not contains_hydrogen(parse_cif(f.read())):
                    keep.append(p)
        except OSError:
            continue
    return keep


def fetch_cifs(selection_file: str, save_dir: str, n: int,
               opener: Callable[[str], bytes] | None = None,
               no_h_only: bool = False, seed: int | None = None) -> int:
    """Download up to `n` CIFs from the newline-separated URL selection
    (reference download_cifs.py). `opener(url) -> bytes` defaults to
    urllib — inject a fake in zero-egress environments/tests. Returns the
    number saved."""
    if opener is None:
        from urllib.request import urlopen

        def opener(url):  # pragma: no cover - needs network
            return urlopen(url).read()

    with open(selection_file) as f:
        urls = [u for u in f.read().split("\n") if u]
    rng = random.Random(seed)
    rng.shuffle(urls)
    os.makedirs(save_dir, exist_ok=True)
    saved = 0
    for url in urls:
        if saved >= n:
            break
        try:
            blob = opener(url)
            if no_h_only and contains_hydrogen(
                    parse_cif(blob.decode(errors="replace"))):
                continue
            with open(os.path.join(save_dir, f"{saved}.cif"), "wb") as w:
                w.write(blob)
            saved += 1
        except Exception:
            continue
    return saved


def stage_felix_jobs(cif_paths: list[str], template_dirs: list[str],
                     out_dir: str, n: int, seed: int = 0) -> int:
    """Create `n` felix simulation job dirs, each pairing a (shuffled,
    round-robin) hydrogen-free CIF with a template's felix.inp/felix.hkl
    (reference copy_no_H.py:15-30). Returns the number staged."""
    if not cif_paths or not template_dirs:
        return 0
    rng = random.Random(seed)
    cifs = list(cif_paths)
    os.makedirs(out_dir, exist_ok=True)
    staged = 0
    for i in range(n):
        j = i % len(cifs)
        k = i % len(template_dirs)
        if j == 0:
            rng.shuffle(cifs)
        d = os.path.join(out_dir, str(i))
        os.makedirs(d, exist_ok=True)
        shutil.copyfile(os.path.join(template_dirs[k], "felix.inp"),
                        os.path.join(d, "felix.inp"))
        shutil.copyfile(os.path.join(template_dirs[k], "felix.hkl"),
                        os.path.join(d, "felix.hkl"))
        shutil.copyfile(cifs[j], os.path.join(d, "felix.cif"))
        staged += 1
    return staged
