"""Lens profile database: lensfun-XML parsing + EXIF-driven lookup — the
JAX package's ``io/lensdb.py``, as the port's own copy (it reads the
port's own ``data/lenses.xml``).

Capability parity with v1's automatic lensfun resolution
(python-legacy/raw_image_editor/editor.py:425-711: EXIF camera/lens ->
lensfunpy DB -> vignetting/TCA/distortion modifiers). Here:

* ``LensDatabase.load`` parses lensfun-format XML files — the bundled
  starter set (data/lenses.xml, approximate profiles) and/or any
  directory of real lensfun ``*.xml`` files the user points at
  (``db_paths``), so an actual lensfun checkout drops in unchanged.
* ``LensDatabase.profile_for`` resolves (LensModel, focal, aperture) ->
  ops/lenscorr.LensProfile, interpolating distortion/TCA linearly between
  the calibrated focal lengths that bracket the shot's focal, and
  vignetting bilinearly over (focal, aperture) — the lensfun behavior v1
  inherits through lensfunpy — with crop-factor coordinate rescaling when
  the shooting body's crop differs from the calibration camera's.
* Matching is fuzzy the way lensfun's is in practice: casefolded exact
  match first, then substring containment either way, then token overlap.

Supported calibration models (the common ones): distortion ``poly3``,
``poly5`` and ``ptlens``, ``tca`` linear/poly3 (constant term),
``vignetting`` ``pa``.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import os
import xml.etree.ElementTree as ET
from typing import Optional

from ..ops.lenscorr import LensProfile

_BUNDLED = os.path.join(os.path.dirname(__file__), "..", "data", "lenses.xml")


@dataclasses.dataclass
class _Calib:
    focal: float
    data: tuple
    model: str = ""
    aperture: float = 0.0


@dataclasses.dataclass
class LensEntry:
    maker: str
    model: str
    mount: str = ""
    crop_factor: float = 1.0
    distortion: list = dataclasses.field(default_factory=list)
    tca: list = dataclasses.field(default_factory=list)
    vignetting: list = dataclasses.field(default_factory=list)
    # True when the source database declares provenance="approximate" on
    # its root element (the bundled starter set does); propagated to
    # LensProfile.approximate so every surface can mark the correction.
    approximate: bool = False


def _norm(s: str) -> str:
    return " ".join((s or "").casefold().split())


def _parse_number(v) -> Optional[float]:
    """EXIF numeric forms: 50, "50", "50/1", "50 mm", "f/2.8". A value
    that cannot be parsed returns None (the caller treats it as
    'unknown', not 'calibration 0') — editor.py:456-483 _parse_number."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v) if v > 0 else None
    from .exif import parse_rational

    s = str(v).strip()
    for cand in (s, s.split()[0] if s.split() else "",
                 s.split("/", 1)[-1] if s.casefold().startswith("f/") else ""):
        if not cand:
            continue
        nd = parse_rational(cand)
        if nd is not None and nd[0] > 0:
            return nd[0] / nd[1]
    return None


def _lerp_data(c0: _Calib, c1: _Calib, t: float) -> tuple:
    return tuple(a * (1.0 - t) + b * t for a, b in zip(c0.data, c1.data))


def _interp_focal(calibs: list[_Calib], focal: Optional[float]
                  ) -> Optional[_Calib]:
    """Interpolate calibration parameters linearly between the two focal
    lengths bracketing ``focal`` (what lensfun — and v1 via lensfunpy,
    editor.py:425-711 — does between calibration points; nearest-neighbor
    is measurably off a stop away from a calibrated focal). Clamped to
    the endpoints outside the calibrated range; exact at calibration
    points. Only same-model points interpolate — with mixed models the
    group of the nearest point wins (coefficients of different models are
    not commensurable)."""
    if not calibs:
        return None
    if focal is None:
        return calibs[0]
    near = min(calibs, key=lambda c: abs(c.focal - focal))
    group = sorted((c for c in calibs if c.model == near.model),
                   key=lambda c: c.focal)
    lo = [c for c in group if c.focal <= focal]
    hi = [c for c in group if c.focal >= focal]
    if not lo:
        return group[0]
    if not hi:
        return group[-1]
    c0, c1 = lo[-1], hi[0]
    if c1.focal == c0.focal:
        return c0
    t = (focal - c0.focal) / (c1.focal - c0.focal)
    return _Calib(focal, _lerp_data(c0, c1, t), c0.model)


def _interp_vignetting(calibs: list[_Calib], focal: Optional[float],
                       aperture: Optional[float]) -> Optional[_Calib]:
    """Bilinear interpolation of pa-model vignetting over (focal,
    aperture): at each of the two bracketing focals the parameters are
    interpolated linearly across aperture (clamped at the calibrated
    ends), then linearly across focal — the lensfun behavior v1 inherits
    through lensfunpy. With no aperture the nearest-aperture column is
    used at each focal."""
    if not calibs:
        return None
    if focal is None:
        return calibs[0]

    def at_focal(f: float) -> Optional[_Calib]:
        col = sorted((c for c in calibs if c.focal == f),
                     key=lambda c: c.aperture)
        if not col:
            return None
        if aperture is None:
            return col[0]
        lo = [c for c in col if c.aperture <= aperture]
        hi = [c for c in col if c.aperture >= aperture]
        if not lo:
            return col[0]
        if not hi:
            return col[-1]
        a0, a1 = lo[-1], hi[0]
        if a1.aperture == a0.aperture:
            return a0
        t = (aperture - a0.aperture) / (a1.aperture - a0.aperture)
        return _Calib(f, _lerp_data(a0, a1, t), a0.model,
                      aperture)

    focals = sorted({c.focal for c in calibs})
    f_lo = [f for f in focals if f <= focal]
    f_hi = [f for f in focals if f >= focal]
    if not f_lo:
        v = at_focal(focals[0])
    elif not f_hi:
        v = at_focal(focals[-1])
    else:
        c0, c1 = at_focal(f_lo[-1]), at_focal(f_hi[0])
        if c0 is None or c1 is None or c1.focal == c0.focal:
            v = c0 or c1
        else:
            t = (focal - c0.focal) / (c1.focal - c0.focal)
            v = _Calib(focal, _lerp_data(c0, c1, t), c0.model,
                       aperture if aperture is not None else c0.aperture)
    return v


class LensDatabase:
    def __init__(self, lenses: list[LensEntry]):
        self.lenses = lenses
        self.skipped_files: list[str] = []  # unparseable DB files (load)

    # -- loading -------------------------------------------------------------
    @classmethod
    def load(cls, db_paths=None, include_bundled: bool = True) -> "LensDatabase":
        """Parse lensfun XML files (memoized per path set — batch runs
        with --lens-correct open many images against one database).
        ``db_paths``: file or directory paths (directories are scanned
        for ``*.xml``). The returned instance is shared between callers
        with the same (files, mtimes) — treat it as read-only."""
        if isinstance(db_paths, (str, os.PathLike)):
            # A bare path would be iterated character-by-character below,
            # silently loading nothing from the user's database.
            db_paths = [os.fspath(db_paths)]
        files = []
        if include_bundled and os.path.exists(_BUNDLED):
            files.append(_BUNDLED)
        for p in db_paths or []:
            if os.path.isdir(p):
                files.extend(sorted(glob.glob(os.path.join(p, "*.xml"))))
            else:
                files.append(p)

        def mtime(f):
            try:
                return os.stat(f).st_mtime_ns
            except OSError:
                return None

        # The memo key carries each file's mtime so XML files added to a
        # pointed-at directory or edited on disk during a long-lived server
        # process are re-read, not served stale from the cache.
        return cls._load_cached(tuple((f, mtime(f)) for f in files))

    @classmethod
    @functools.lru_cache(maxsize=8)
    def _load_cached(cls, files_with_mtimes) -> "LensDatabase":
        files = [f for f, _ in files_with_mtimes]
        lenses: list[LensEntry] = []
        skipped: list[str] = []
        for f in files:
            try:
                lenses.extend(cls._parse_file(f))
            except (ET.ParseError, ValueError, OSError):
                # One corrupt file in a user-pointed DB directory must not
                # take down the open — the image still develops, just
                # without that file's profiles.
                skipped.append(f)
        db = cls(lenses)
        db.skipped_files = skipped
        return db

    @classmethod
    def _parse_file(cls, path: str) -> list[LensEntry]:
        tree = ET.parse(path)
        return cls._parse_root(tree.getroot())

    @classmethod
    def parse_xml(cls, text: str) -> "LensDatabase":
        return cls(cls._parse_root(ET.fromstring(text)))

    @staticmethod
    def _parse_root(root) -> list[LensEntry]:
        out = []
        # Database-level provenance marker: real lensfun files carry no
        # such attribute (-> calibrated); the bundled starter set is
        # explicitly stamped approximate.
        approx = (root.get("provenance", "") or "").strip() == "approximate"
        for lens in root.iter("lens"):
            entry = LensEntry(
                maker=(lens.findtext("maker") or "").strip(),
                model=(lens.findtext("model") or "").strip(),
                mount=(lens.findtext("mount") or "").strip(),
                crop_factor=float(lens.findtext("cropfactor") or 1.0),
                approximate=approx,
            )
            calib = lens.find("calibration")
            if calib is None:
                continue
            for d in calib.iter("distortion"):
                model = d.get("model", "poly3")
                focal = float(d.get("focal", 0))
                if model == "poly3":
                    entry.distortion.append(
                        _Calib(focal, (float(d.get("k1", 0)),), "poly3"))
                elif model == "poly5":
                    # Native poly5: r_src = r (1 + k1 r^2 + k2 r^4) —
                    # anchored at the center (NOT poly3's r=1 anchor, so
                    # plugging k1 into poly3 would add a spurious uniform
                    # ~(1-k1) scale).
                    entry.distortion.append(_Calib(
                        focal,
                        (float(d.get("k1", 0)), float(d.get("k2", 0))),
                        "poly5"))
                elif model == "ptlens":
                    entry.distortion.append(_Calib(
                        focal,
                        (float(d.get("a", 0)), float(d.get("b", 0)),
                         float(d.get("c", 0))),
                        "ptlens",
                    ))
            for t in calib.iter("tca"):
                focal = float(t.get("focal", 0))
                # linear: vr/vb; poly3 tca: use the constant terms vr/vb.
                vr = float(t.get("vr", 1.0))
                vb = float(t.get("vb", 1.0))
                entry.tca.append(_Calib(focal, (vr, vb), t.get("model", "linear")))
            for v in calib.iter("vignetting"):
                if v.get("model", "pa") != "pa":
                    continue
                entry.vignetting.append(_Calib(
                    float(v.get("focal", 0)),
                    (float(v.get("k1", 0)), float(v.get("k2", 0)),
                     float(v.get("k3", 0))),
                    "pa",
                    float(v.get("aperture", 0)),
                ))
            out.append(entry)
        return out

    # -- lookup --------------------------------------------------------------
    def find_lens(self, lens_model: str, maker: Optional[str] = None,
                  calibrated_only: bool = False) -> Optional[LensEntry]:
        """Fuzzy-resolve a lens entry from an EXIF LensModel string.
        ``calibrated_only`` skips approximate-provenance entries (the
        --lens-correct=calibrated-only policy)."""
        lenses = ([e for e in self.lenses if not e.approximate]
                  if calibrated_only else self.lenses)
        want = _norm(lens_model)
        if not want:
            return None
        maker_n = _norm(maker) if maker else None

        def maker_ok(e: LensEntry) -> bool:
            if not maker_n:
                return True
            em = _norm(e.maker)
            return not em or em in maker_n or maker_n in em

        want_sq = want.replace(" ", "")

        def search(candidates, fuzzy=True):
            for e in candidates:                   # exact
                if _norm(e.model) == want:
                    return e
            for e in candidates:                   # containment
                em = _norm(e.model)
                if em and (em in want or want in em):
                    return e
            for e in candidates:                   # squeezed containment
                # Fuji-style EXIF drops the spaces ("XF18-55mmF2.8-4 R
                # LM OIS"); compare with all whitespace removed so the
                # squeezed form still requires one FULL string inside
                # the other (no token-soup false positives).
                em = _norm(e.model).replace(" ", "")
                if em and (em in want_sq or want_sq in em):
                    return e
            if not fuzzy:
                return None
            best, best_score = None, 0.0           # token overlap
            want_tokens = set(want.split())
            for e in candidates:
                toks = set(_norm(e.model).split())
                if not toks:
                    continue
                score = len(toks & want_tokens) / len(toks | want_tokens)
                if score > best_score:
                    best, best_score = e, score
            return best if best_score >= 0.5 else None

        found = search([e for e in lenses if maker_ok(e)])
        if found is None and maker_n:
            # Retry maker-unqualified (editor.py:531-549 retries
            # find_lenses with maker=None): the caller often passes the
            # camera BODY Make, which legitimately differs from the lens
            # maker for third-party glass (body 'Canon', lens 'Sigma ...').
            # EXACT/containment tiers only: third-party LensModel strings
            # name their maker ('Sigma 35mm ...'), while a weak token
            # match across makers ('50mm f/1.8' ~ another brand's
            # fifty) would warp the wrong profile into the pixels.
            found = search(lenses, fuzzy=False)
        return found

    def profile_for(
        self,
        lens_model: str,
        focal: Optional[float] = None,
        aperture: Optional[float] = None,
        maker: Optional[str] = None,
        cam_crop_factor: Optional[float] = None,
        calibrated_only: bool = False,
    ) -> Optional[LensProfile]:
        """Resolve EXIF fields to an applicable LensProfile (or None).

        Calibration parameters are interpolated between calibrated focal
        lengths (and, for vignetting, apertures). When the shooting
        camera's crop factor differs from the calibration entry's, the
        profile carries the coordinate rescale calib_crop/cam_crop
        (LensProfile.radius_scale): the correction polynomials are then
        evaluated in the calibration camera's frame, like lensfun does
        when pairing a lens profile with a different-crop body."""
        entry = self.find_lens(lens_model, maker,
                               calibrated_only=calibrated_only)
        if entry is None:
            return None
        dist = _interp_focal(entry.distortion, focal)
        tca = _interp_focal(entry.tca, focal)
        vig = _interp_vignetting(entry.vignetting, focal, aperture)
        if dist is None and tca is None and vig is None:
            return None
        radius_scale = 1.0
        if cam_crop_factor and cam_crop_factor > 0 and entry.crop_factor > 0:
            radius_scale = entry.crop_factor / cam_crop_factor
        return LensProfile(
            name=entry.model,
            vignetting=vig.data if vig else None,
            distortion_model=dist.model if dist else "poly3",
            distortion=dist.data if dist else None,
            tca=tca.data if tca else None,
            radius_scale=radius_scale,
            approximate=entry.approximate,
        )

    def profile_from_exif(self, exif: dict,
                          calibrated_only: bool = False
                          ) -> Optional[LensProfile]:
        """Resolve from the session's EXIF dict (LensModel falling back to
        the body Model for fixed-lens cameras, editor.py:425-711 order).
        The camera crop factor comes from FocalLengthIn35mmFilm /
        FocalLength when both are present (the standard EXIF route to it;
        absent -> assume the calibration crop)."""
        lens = exif.get("LensModel") or exif.get("Model")
        if not lens:
            return None
        focal = _parse_number(exif.get("FocalLength"))
        aperture = _parse_number(exif.get("FNumber"))
        equiv35 = _parse_number(exif.get("FocalLengthIn35mmFilm")
                                or exif.get("FocalLenIn35mmFilm"))
        crop = (equiv35 / focal) if (equiv35 and focal) else None
        return self.profile_for(
            lens, focal=focal, aperture=aperture,
            maker=exif.get("LensMake") or exif.get("Make"),
            cam_crop_factor=crop,
            calibrated_only=calibrated_only,
        )
