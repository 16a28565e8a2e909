"""ISOBMFF box grammar: typed metadata records for the HEIF container.

Host-side metadata model (parity target: reference src/heif/grammar.rs:1-319).
These are plain dataclasses — container metadata is KB-scale and never touches
the TPU; the device only ever sees tile bitstream bytes and decoded planes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class ItemType(Enum):
    """Item kinds appearing in `infe` boxes (reference src/heif/grammar.rs:170-181)."""

    MIME = "mime"
    URI = "uri "
    HVC1 = "hvc1"
    GRID = "grid"
    EXIF = "Exif"
    UNKNOWN = "????"

    @classmethod
    def from_fourcc(cls, fourcc: str) -> "ItemType":
        for member in cls:
            if member.value == fourcc:
                return member
        return cls.UNKNOWN


@dataclass(frozen=True)
class VersionFlags:
    """FullBox version byte + 24-bit flags (reference src/heif/grammar.rs:89-97)."""

    version: int
    flags: int


@dataclass
class FileTypeBox:
    major_brand: str
    minor_version: int
    compatible_brands: list[str]


@dataclass
class HandlerBox:
    handler_type: str  # must be 'pict' for HEIF images
    name: str = ""


@dataclass
class PrimaryItemBox:
    item_id: int


@dataclass
class ItemInfoEntry:
    item_id: int
    item_protection_index: int
    item_type: ItemType
    item_type_fourcc: str
    item_name: str = ""
    content_type: Optional[str] = None  # for mime items
    content_encoding: Optional[str] = None
    item_uri_type: Optional[str] = None  # for uri items
    hidden: bool = False  # infe flags bit 0


@dataclass
class ItemInfoBox:
    entries: list[ItemInfoEntry] = field(default_factory=list)


@dataclass
class SingleItemReference:
    """One reference record inside `iref` (reference src/heif/grammar.rs:196-207)."""

    reference_type: str  # 'dimg' | 'thmb' | 'cdsc' | 'auxl' | ...
    from_item_id: int
    to_item_ids: list[int]


@dataclass
class ItemReferenceBox:
    references: list[SingleItemReference] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Item properties (ipco contents)
# ---------------------------------------------------------------------------


@dataclass
class ColorInformationProperty:
    colour_type: str  # 'nclx' | 'rICC' | 'prof'
    colour_primaries: Optional[int] = None
    transfer_characteristics: Optional[int] = None
    matrix_coefficients: Optional[int] = None
    full_range: Optional[bool] = None
    icc_profile: Optional[bytes] = None


@dataclass
class ImageSpatialExtentsProperty:
    width: int
    height: int


@dataclass
class ImageRotationProperty:
    angle: int  # multiples of 90 degrees CCW (0..3)


@dataclass
class PixelInformationProperty:
    bits_per_channel: list[int]


@dataclass
class NalArray:
    """One NAL-unit array from an hvcC record (reference src/hevc/grammar.rs:328-347)."""

    array_completeness: bool
    nal_unit_type: int
    nal_units: list[bytes]


@dataclass
class HevcDecoderConfigurationRecord:
    """HEVCDecoderConfigurationRecord, ISO/IEC 14496-15 §8.3.3.1.

    Parity target: reference src/hevc/grammar.rs:157-221 and
    src/heif/reader.rs:570-630. Only configurationVersion==1 is accepted,
    matching the reference restriction (src/heif/reader.rs:573).
    """

    configuration_version: int
    general_profile_space: int
    general_tier_flag: int
    general_profile_idc: int
    general_profile_compatibility_flags: int
    general_constraint_indicator_flags: int
    general_level_idc: int
    min_spatial_segmentation_idc: int
    parallelism_type: int
    chroma_format_idc: int
    bit_depth_luma_minus8: int
    bit_depth_chroma_minus8: int
    avg_frame_rate: int
    constant_frame_rate: int
    num_temporal_layers: int
    temporal_id_nested: int
    length_size_minus_one: int
    nal_arrays: list[NalArray]

    def nal_units_of_type(self, nal_type: int) -> list[bytes]:
        out: list[bytes] = []
        for arr in self.nal_arrays:
            if arr.nal_unit_type == nal_type:
                out.extend(arr.nal_units)
        return out


@dataclass
class UnknownProperty:
    fourcc: str
    payload: bytes


ItemProperty = (
    ColorInformationProperty
    | HevcDecoderConfigurationRecord
    | ImageSpatialExtentsProperty
    | ImageRotationProperty
    | PixelInformationProperty
    | UnknownProperty
)


@dataclass
class PropertyAssociation:
    property_index: int  # 1-based index into ipco
    essential: bool


@dataclass
class ItemPropertyAssociation:
    """ipma entries: item id → ordered ipco property indices
    (reference src/heif/reader.rs:476-511)."""

    entries: dict[int, list[PropertyAssociation]] = field(default_factory=dict)


@dataclass
class ItemPropertiesBox:
    properties: list[ItemProperty] = field(default_factory=list)  # ipco order
    association: ItemPropertyAssociation = field(
        default_factory=ItemPropertyAssociation
    )

    def properties_for_item(self, item_id: int) -> list[ItemProperty]:
        assocs = self.association.entries.get(item_id, [])
        out = []
        for a in assocs:
            if 1 <= a.property_index <= len(self.properties):
                out.append(self.properties[a.property_index - 1])
        return out

    def property_of_type(self, item_id: int, prop_cls) -> Optional[ItemProperty]:
        for p in self.properties_for_item(item_id):
            if isinstance(p, prop_cls):
                return p
        return None


# ---------------------------------------------------------------------------
# Item location
# ---------------------------------------------------------------------------


@dataclass
class ItemExtent:
    extent_index: int
    extent_offset: int
    extent_length: int


@dataclass
class ItemLocation:
    item_id: int
    construction_method: int  # 0 = file offset, 1 = idat offset, 2 = item offset
    data_reference_index: int
    base_offset: int
    extents: list[ItemExtent]


@dataclass
class ItemLocationBox:
    locations: dict[int, ItemLocation] = field(default_factory=dict)


@dataclass
class DataEntry:
    entry_type: str  # 'url ' | 'urn '
    self_contained: bool
    location: Optional[str] = None
    name: Optional[str] = None


@dataclass
class DataInformationBox:
    entries: list[DataEntry] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Grid image item payload (ISO/IEC 23008-12 §6.6.2.3.2)
# ---------------------------------------------------------------------------


@dataclass
class GridConfig:
    rows: int
    columns: int
    output_width: int
    output_height: int


@dataclass
class MetaBox:
    handler: HandlerBox
    primary_item: Optional[PrimaryItemBox] = None
    item_info: ItemInfoBox = field(default_factory=ItemInfoBox)
    item_references: ItemReferenceBox = field(default_factory=ItemReferenceBox)
    item_properties: ItemPropertiesBox = field(default_factory=ItemPropertiesBox)
    item_locations: ItemLocationBox = field(default_factory=ItemLocationBox)
    data_information: Optional[DataInformationBox] = None
    idat: bytes = b""


@dataclass
class Heif:
    """Top-level parsed container (reference src/heif/grammar.rs:26-49)."""

    file_type: FileTypeBox
    meta: MetaBox

    # -- accessors mirroring the reference's Heif impl --

    def primary_item_id(self) -> int:
        if self.meta.primary_item is None:
            raise ValueError("container has no pitm box")
        return self.meta.primary_item.item_id

    def item_info_by_item_id(self, item_id: int) -> Optional[ItemInfoEntry]:
        for e in self.meta.item_info.entries:
            if e.item_id == item_id:
                return e
        return None

    def hevc_configuration_record(
        self, item_id: Optional[int] = None
    ) -> Optional[HevcDecoderConfigurationRecord]:
        """hvcC record associated with `item_id` (default: primary item; if the
        primary is a grid, the first hvc1 tile's record — matching the
        reference, which returns the first hvcC found in ipco,
        src/heif/grammar.rs:38-49)."""
        if item_id is not None:
            rec = self.meta.item_properties.property_of_type(
                item_id, HevcDecoderConfigurationRecord
            )
            if rec is not None:
                return rec
        for p in self.meta.item_properties.properties:
            if isinstance(p, HevcDecoderConfigurationRecord):
                return p
        return None

    def item_ids_referencing(self, item_id: int, reference_type: str) -> list[int]:
        """to_item_ids of the `reference_type` reference whose from-item is
        `item_id` (e.g. grid → 'dimg' → tile ids)."""
        for r in self.meta.item_references.references:
            if r.reference_type == reference_type and r.from_item_id == item_id:
                return list(r.to_item_ids)
        return []

    def items_referring_to(self, item_id: int, reference_type: str) -> list[int]:
        """from_item_ids of references of `reference_type` pointing at `item_id`
        (e.g. thumbnails of the primary: 'thmb')."""
        out = []
        for r in self.meta.item_references.references:
            if r.reference_type == reference_type and item_id in r.to_item_ids:
                out.append(r.from_item_id)
        return out
