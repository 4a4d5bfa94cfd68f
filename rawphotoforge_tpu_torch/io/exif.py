"""EXIF metadata extraction (the JAX package's ``io/exif.py``).

Mirrors the reference's 11-field Exif struct
(rust/photo-editor/src/metadata.rs:6-18) and its tag mapping
(rust/photo-editor/src/image.rs:449-477). Pillow is imported only inside
the functions that need it, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Exif:
    datetime: Optional[str] = None
    f_number: Optional[float] = None
    flash: Optional[str] = None
    lens_make: Optional[str] = None
    lens_model: Optional[str] = None
    model: Optional[str] = None
    make: Optional[str] = None
    focal_length: Optional[int] = None
    exposure_time: Optional[str] = None
    iso: Optional[int] = None
    exposure_bias: Optional[float] = None

    def to_dict(self) -> dict:
        """Key names per Exif::to_hashmap (metadata.rs:21-59)."""
        out = {}
        if self.datetime is not None:
            out["DateTimeOriginal"] = self.datetime
        if self.f_number is not None:
            out["FNumber"] = str(self.f_number)
        if self.exposure_time is not None:
            out["ExposureTime"] = self.exposure_time
        if self.iso is not None:
            out["ISO"] = str(self.iso)
        if self.exposure_bias is not None:
            out["ExposureBiasValue"] = str(self.exposure_bias)
        if self.focal_length is not None:
            out["FocalLength"] = str(self.focal_length)
        if self.make is not None:
            out["Make"] = self.make
        if self.model is not None:
            out["Model"] = self.model
        if self.lens_make is not None:
            out["LensMake"] = self.lens_make
        if self.lens_model is not None:
            out["LensModel"] = self.lens_model
        if self.flash is not None:
            out["Flash"] = self.flash
        return out


def parse_rational(v, max_num=0xFFFFFFFF):
    """Parse an exif-dict value ("1/250", "2.8", 35.0) into an unsigned
    TIFF RATIONAL (numerator, denominator), or None if unrepresentable."""
    from fractions import Fraction

    try:
        s = str(v)
        if "/" in s:
            n, d = s.split("/", 1)
            n, d = int(round(float(n))), int(round(float(d)))
        else:
            f = Fraction(float(s)).limit_denominator(100000)
            n, d = f.numerator, f.denominator
        if 0 <= n <= max_num and 0 < d <= max_num:
            return (n, d)
    except (ValueError, OverflowError, ZeroDivisionError):
        pass
    return None


def _ratio_to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def parse_exif(img) -> dict:
    """Extract the reference's 11 EXIF fields from a PIL image as a dict."""
    from PIL.ExifTags import Base as ExifTag

    try:
        raw = img.getexif()
    except Exception:  # noqa: BLE001 — metadata is best-effort
        return {}
    if not raw:
        return {}
    merged = dict(raw)
    try:
        merged.update(raw.get_ifd(0x8769))  # Exif sub-IFD
    except Exception:  # noqa: BLE001
        pass

    e = Exif()
    if ExifTag.DateTimeOriginal in merged:
        e.datetime = str(merged[ExifTag.DateTimeOriginal])
    elif ExifTag.DateTime in merged:
        e.datetime = str(merged[ExifTag.DateTime])
    if ExifTag.FNumber in merged:
        e.f_number = _ratio_to_float(merged[ExifTag.FNumber])
    if ExifTag.Flash in merged:
        e.flash = str(merged[ExifTag.Flash])
    if ExifTag.LensMake in merged:
        e.lens_make = str(merged[ExifTag.LensMake])
    if ExifTag.LensModel in merged:
        e.lens_model = str(merged[ExifTag.LensModel])
    if ExifTag.Model in merged:
        e.model = str(merged[ExifTag.Model])
    if ExifTag.Make in merged:
        e.make = str(merged[ExifTag.Make])
    if ExifTag.FocalLength in merged:
        fl = _ratio_to_float(merged[ExifTag.FocalLength])
        if fl is not None:
            e.focal_length = int(fl)
    if ExifTag.ExposureTime in merged:
        et = merged[ExifTag.ExposureTime]
        f = _ratio_to_float(et)
        if f is not None and f > 0 and f < 1:
            e.exposure_time = f"1/{round(1.0 / f)}"
        else:
            e.exposure_time = str(et)
    if ExifTag.ISOSpeedRatings in merged:
        iso = merged[ExifTag.ISOSpeedRatings]
        if isinstance(iso, (tuple, list)) and iso:
            iso = iso[0]
        try:
            e.iso = int(iso)
        except (TypeError, ValueError):
            pass
    if ExifTag.ExposureBiasValue in merged:
        e.exposure_bias = _ratio_to_float(merged[ExifTag.ExposureBiasValue])
    out = e.to_dict()
    if ExifTag.FocalLengthIn35mmFilm in merged:
        f35 = _ratio_to_float(merged[ExifTag.FocalLengthIn35mmFilm])
        if f35 is not None and f35 > 0:
            out["FocalLengthIn35mmFilm"] = str(int(f35))
    return out
