"""ICC profile header + tag-table parser (host metadata layer).

The reference ships a dead-code ICC skeleton (`src/color/reader.rs:11-135`
is never compiled: `src/lib.rs:3-8` declares no `mod color`, and its one
call site is commented out at `src/heif/reader.rs:522-523`). This module
completes that capability: `colr` boxes of type `prof`/`rICC` carry a raw
ICC payload, and `parse_icc_header` decodes the 128-byte profile header
(ICC.1:2022 §7.2) plus the tag table (§7.3) so `probe`/CLI output can
report the actual color management data instead of an opaque blob.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


_PROFILE_CLASSES = {
    "scnr": "input",
    "mntr": "display",
    "prtr": "output",
    "link": "devicelink",
    "spac": "colorspace",
    "abst": "abstract",
    "nmcl": "namedcolor",
}

_PLATFORMS = {
    "APPL": "Apple",
    "MSFT": "Microsoft",
    "SGI ": "Silicon Graphics",
    "SUNW": "Sun Microsystems",
}


@dataclass
class IccTag:
    signature: str
    offset: int
    size: int


@dataclass
class IccProfile:
    size: int
    preferred_cmm: str
    version: str  # "major.minor.bugfix"
    profile_class: str  # decoded name (or raw fourcc)
    color_space: str
    pcs: str
    creation: tuple  # (year, month, day, hour, minute, second)
    platform: str
    rendering_intent: int
    creator: str
    description: str | None = None
    tags: list[IccTag] = field(default_factory=list)


def _fourcc(b: bytes) -> str:
    return b.decode("latin-1")


def parse_icc_header(data: bytes) -> IccProfile:
    """Parse the ICC profile header + tag table from a raw `prof`/`rICC`
    payload. Raises ValueError on malformed input."""
    if len(data) < 132:
        raise ValueError(f"ICC payload too short: {len(data)} bytes")
    if data[36:40] != b"acsp":
        raise ValueError("missing 'acsp' profile signature")
    size = struct.unpack_from(">I", data, 0)[0]
    ver_raw = data[8:12]
    version = f"{ver_raw[0]}.{ver_raw[1] >> 4}.{ver_raw[1] & 15}"
    cls = _fourcc(data[12:16])
    y, mo, d, h, mi, s = struct.unpack_from(">6H", data, 24)
    intent = struct.unpack_from(">I", data, 64)[0]

    n_tags = struct.unpack_from(">I", data, 128)[0]
    if n_tags > 1024 or 132 + 12 * n_tags > len(data):
        raise ValueError(f"implausible ICC tag count {n_tags}")
    tags = []
    desc = None
    for i in range(n_tags):
        sig, off, ln = struct.unpack_from(">4sII", data, 132 + 12 * i)
        tags.append(IccTag(_fourcc(sig), off, ln))
        if sig in (b"desc",) and desc is None and off + 12 <= len(data):
            # 'desc' (textDescriptionType) or 'mluc' payloads
            t = data[off : off + 4]
            if t == b"desc" and off + 12 <= len(data):
                cnt = struct.unpack_from(">I", data, off + 8)[0]
                raw = data[off + 12 : off + 12 + min(cnt, 256)]
                desc = raw.split(b"\0", 1)[0].decode("latin-1", "replace")
            elif t == b"mluc" and off + 16 <= len(data):
                nrec = struct.unpack_from(">I", data, off + 8)[0]
                if nrec >= 1 and off + 28 <= len(data):
                    ln2, off2 = struct.unpack_from(">II", data, off + 20)
                    raw = data[off + off2 : off + off2 + min(ln2, 512)]
                    desc = raw.decode("utf-16-be", "replace").strip("\0")

    return IccProfile(
        size=size,
        preferred_cmm=_fourcc(data[4:8]),
        version=version,
        profile_class=_PROFILE_CLASSES.get(cls, cls),
        color_space=_fourcc(data[16:20]).strip(),
        pcs=_fourcc(data[20:24]).strip(),
        creation=(y, mo, d, h, mi, s),
        platform=_PLATFORMS.get(_fourcc(data[40:44]), _fourcc(data[40:44]).strip()),
        rendering_intent=intent,
        creator=_fourcc(data[80:84]).strip(),
        description=desc,
        tags=tags,
    )
