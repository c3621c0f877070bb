"""
Low-dose CT datasets (counterpart of ``fmdm_tpu/data/ldct.py``): paired
SDCT/LDCT volumes, HU conversion, the CT window to [0, 1], each case
expanded into per-window samples (a case whose two volumes have different
window counts is skipped), lot ids, and the output writers (PNG + 12-bit
DICOM, ``.npy`` in place of DICOM without pydicom).

The index is a list of dicts where the JAX package builds DataFrames; the
rows and their values are the same. A lot id replaces the case id of a row
whose volume entry is a list of files (a window of a DICOM directory).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from fmdm_tpu_torch.data.base import BaseDataset, complete_rows
from fmdm_tpu_torch.data.dataset_utils import (
    absolute_path,
    cache_path_for_entry,
    maybe_unwrap,
    resolve_entry,
    save_tensor_cache,
    split_volume_entry,
)
from fmdm_tpu_torch.data.io import resize_array

try:
    from PIL import Image as PILImage
except ImportError:  # pragma: no cover - optional
    PILImage = None

try:
    import pydicom
    from pydicom.dataset import Dataset as DICOMDataset
    from pydicom.dataset import FileDataset
except ImportError:  # pragma: no cover - optional
    pydicom = DICOMDataset = FileDataset = None

# CT window: the full soft-tissue-to-bone HU range
HU_WINDOW_LO = -1024.0
HU_WINDOW_HI = 3072.0


def _stem(path_like) -> str:
    """File name without directory or extensions ("a/b/012.dcm" -> "012")."""
    return os.path.basename(str(path_like)).split(".")[0]


def lot_id(rows: List[dict], case_column: str, number_column: str) -> List[dict]:
    """Copies of ``rows`` where each row whose ``number_column`` is a
    non-empty list of files gets the case id I<case>S<row>F<first stem>T<last
    stem>C<count>; other rows keep theirs."""
    out = []
    for idx, row in enumerate(rows):
        row = dict(row)
        files = row[number_column]
        if isinstance(files, (list, tuple)) and files:
            row[case_column] = (f"I{row[case_column]}S{idx}F{_stem(files[0])}"
                                f"T{_stem(files[-1])}C{len(files)}")
        out.append(row)
    return out


def _meta_lookup(meta: Optional[dict], spaced: str, camel: str, default=None):
    """A DICOM metadata value under its spaced ("Rescale Slope") or
    CamelCase ("RescaleSlope") key."""
    if meta is None:
        return default
    return meta.get(spaced, meta.get(camel, default))


class LDCTDataset(BaseDataset):
    """Paired-volume CT dataset. Each row of the split file names a case and
    its SDCT/LDCT volumes (files or DICOM directories); the index expands
    each case into per-window samples with their split index and count for
    the tensor cache."""

    def __init__(
        self,
        file_path: str,
        train: bool = True,
        img_size=None,
        window_size: int = 1,
        norm: bool = True,
        img_datatype=np.float32,
        transforms=None,
        load_ldct: bool = False,
        names: Tuple[str, ...] = ("Case", "SDCT", "LDCT"),
        split_file=None,
        use_tensor_cache: bool = True,
        save_tensor_cache: bool = False,
        cache_subdir: str = "cache",
        preprocess_kwargs: Optional[dict] = None,
    ):
        super().__init__(
            file_path=file_path,
            train=train,
            img_size=img_size,
            norm=norm,
            img_datatype=img_datatype,
            transforms=transforms,
            conditioning=load_ldct,
            id_key="Case",
            target_key=names[1],
            conditioning_key=names[2],
            split_names=names,
            split_file=split_file,
            use_tensor_cache=use_tensor_cache,
            save_tensor_cache=save_tensor_cache,
            cache_subdir=cache_subdir,
            preprocess_kwargs=preprocess_kwargs,
        )
        self.names = names
        self.window_size = int(window_size) if window_size is not None else 1
        self._build_ldct_index(names)

    # -- index construction ----------------------------------------------------
    def _windows_for(self, raw_entry) -> list:
        """One volume reference (file or DICOM directory) as its windows."""
        path = absolute_path(self.data_root, raw_entry)
        if path.is_dir():
            return resolve_entry(self.data_root, raw_entry, self.window_size)
        return split_volume_entry(str(path), self.window_size)

    @staticmethod
    def _window_record(window_entry, position: int, total: int):
        """A window entry as (entry, split_index, split_count)."""
        entry = maybe_unwrap(window_entry) if isinstance(window_entry, (list, tuple)) else window_entry
        if isinstance(entry, dict):
            return entry, entry.get("split_index"), entry.get("split_count", total)
        return entry, position, total

    def _build_ldct_index(self, names: Tuple[str, ...]) -> None:
        case_col, target_col, cond_col = names[0], names[1], names[2]
        records = []
        n_cases = 0
        for row in complete_rows(self._read_split_file(self.data_root, names=names)):
            target_windows = self._windows_for(row[target_col])
            cond_windows = self._windows_for(row[cond_col])
            if len(target_windows) != len(cond_windows):
                logging.warning("Skipping case %s due to mismatched slice counts (SDCT=%d, LDCT=%d)",
                                row[case_col], len(target_windows), len(cond_windows))
                continue
            n_cases += 1
            for pos, (tgt_win, cond_win) in enumerate(zip(target_windows, cond_windows)):
                tgt, tgt_idx, tgt_cnt = self._window_record(tgt_win, pos, len(target_windows))
                cond, cond_idx, cond_cnt = self._window_record(cond_win, pos, len(cond_windows))
                records.append({
                    case_col: row[case_col],
                    target_col: tgt,
                    cond_col: cond,
                    f"{target_col}__split_index": tgt_idx,
                    f"{target_col}__split_count": tgt_cnt,
                    f"{cond_col}__split_index": cond_idx,
                    f"{cond_col}__split_count": cond_cnt,
                })
        if not records:
            raise ValueError("Empty Dataset")
        self.data = lot_id(records, case_col, target_col)
        self.size = len(self.data)
        logging.info("LDCT index built: %d cases expanded to %d samples (window_size=%d).",
                     n_cases, self.size, self.window_size)

    def _cache_info(self, entry, row, key: Optional[str]):
        if key is None:
            return None, 1
        return row.get(f"{key}__split_index"), row.get(f"{key}__split_count", 1)

    # -- HU preprocessing ----------------------------------------------------------
    def preprocess(self, payload, MIN_B: float = HU_WINDOW_LO, MAX_B: float = HU_WINDOW_HI,
                   slope: float = 1.0, intersept: float = -1024) -> np.ndarray:
        """Raw pixels -> windowed [0, 1] image with a leading channel dim.
        DICOM rescale tags in the payload's metadata override ``slope`` and
        ``intersept``."""
        img = payload["Image"] if isinstance(payload, dict) else payload
        meta = payload.get("Metadata") if isinstance(payload, dict) else None
        try:
            slope = float(_meta_lookup(meta, "Rescale Slope", "RescaleSlope", slope))
            intersept = float(_meta_lookup(meta, "Rescale Intercept", "RescaleIntercept", intersept))
        except (TypeError, ValueError):
            pass
        hu = self._resize_slices(np.asarray(img) * slope + intersept)
        windowed = self.to_image(hu, MIN_B=MIN_B, MAX_B=MAX_B)
        if windowed.ndim == 2:
            windowed = windowed[np.newaxis]
        return windowed.astype(self.img_datatype)

    def _resize_slices(self, img: np.ndarray) -> np.ndarray:
        if self.img_size is None:
            return img
        if img.ndim == 3:
            # resize works on the trailing dims: slices go channels-last
            return np.transpose(resize_array(np.transpose(img, (1, 2, 0)),
                                             self.img_size + (img.shape[0],)), (2, 0, 1))
        return resize_array(img, self.img_size)

    def to_image(self, img: np.ndarray, MIN_B: float = HU_WINDOW_LO, MAX_B: float = HU_WINDOW_HI) -> np.ndarray:
        """HU -> [0, 1] window (inverted by ``from_image``)."""
        img = np.asarray(img)
        if self.norm:
            img = (img - MIN_B) / ((MAX_B - MIN_B) if MAX_B != MIN_B else 1.0)
        return np.clip(img, 0.0, 1.0).astype(self.img_datatype)

    def from_image(self, img, MIN_B: float = HU_WINDOW_LO, MAX_B: float = HU_WINDOW_HI):
        """[0, 1] window -> HU."""
        img = np.clip(np.asarray(img), 0.0, 1.0)
        return (img * (MAX_B - MIN_B) + MIN_B).astype(self.img_datatype)

    # -- output writers ----------------------------------------------------------
    def save_output(self, row: dict, key: str, tensor, output_root: Path) -> None:
        """A model output at the entry's mirrored path under ``output_root``:
        a 2-D slice as a PNG + DICOM pair, a 3-D volume as a directory of
        DICOM slices, anything else as a tensor file."""
        entry = row.get(key)
        split_index, split_count = self._cache_info(entry, row, key)
        out_path = cache_path_for_entry(self.base_path, output_root, entry, split_index, split_count)
        if out_path is None:
            return
        out_path.parent.mkdir(parents=True, exist_ok=True)

        arr = np.asarray(tensor, dtype=np.float32)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        source_meta = self._source_metadata(row, key)
        if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[0] == 1):
            img2d = arr if arr.ndim == 2 else arr[0]
            self._save_png(img2d, out_path.with_suffix(".png"))
            self._save_dicom_slice(img2d, out_path.with_suffix(".dcm"), metadata=source_meta)
        elif arr.ndim == 3:
            vol_dir = out_path.with_suffix("")
            vol_dir.mkdir(parents=True, exist_ok=True)
            for idx, img2d in enumerate(arr):
                self._save_dicom_slice(img2d, vol_dir / f"slice_{idx:04d}.dcm", metadata=source_meta)
        else:
            save_tensor_cache(arr, out_path)

    def _source_metadata(self, row: dict, key: str):
        """The source entry's DICOM metadata, for the outputs; None when it
        has none or cannot be read again."""
        entry = row.get(key)
        if entry is None:
            return None
        item_id = row.get(self.id_key) if self.id_key else None
        try:
            payload = self._load_entry(entry, item_id)
        except (OSError, ValueError, RuntimeError):
            return None
        return payload.get("Metadata") if isinstance(payload, dict) else None

    @staticmethod
    def _save_png(img: np.ndarray, path: Path) -> None:
        if PILImage is None:
            return
        PILImage.fromarray((np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)).save(path)

    @staticmethod
    def _save_dicom_slice(img: np.ndarray, path: Path, metadata: Optional[dict] = None) -> None:
        if pydicom is None:
            np.save(path.with_suffix(".npy"), np.asarray(img, dtype=np.float32))
            return
        px = np.asarray(np.clip(img, 0.0, 1.0) * 4095.0, dtype=np.uint16)  # 12-bit CT range

        file_meta = DICOMDataset()
        for uid_tag in ("MediaStorageSOPClassUID", "MediaStorageSOPInstanceUID"):
            setattr(file_meta, uid_tag, pydicom.uid.generate_uid())
        file_meta.TransferSyntaxUID = pydicom.uid.ExplicitVRLittleEndian

        ds = FileDataset(str(path), {}, file_meta=file_meta, preamble=b"\0" * 128)
        header = {
            "SOPClassUID": file_meta.MediaStorageSOPClassUID,
            "SOPInstanceUID": file_meta.MediaStorageSOPInstanceUID,
            "Modality": "CT",
            "Rows": int(px.shape[0]),
            "Columns": int(px.shape[1]),
            # monochrome 16-bit-allocated pixel cells
            "SamplesPerPixel": 1,
            "PhotometricInterpretation": "MONOCHROME2",
            "BitsStored": 16,
            "BitsAllocated": 16,
            "HighBit": 15,
            "PixelRepresentation": 0,
            "RescaleSlope": float(_meta_lookup(metadata, "Rescale Slope", "RescaleSlope", 1)),
            "RescaleIntercept": float(_meta_lookup(metadata, "Rescale Intercept", "RescaleIntercept", -1024)),
        }
        for tag, value in header.items():
            setattr(ds, tag, value)
        if metadata is not None:
            LDCTDataset._propagate_geometry(ds, metadata)
        ds.PixelData = px.tobytes()
        ds.save_as(str(path), enforce_file_format=True)

    @staticmethod
    def _propagate_geometry(ds, metadata: dict) -> None:
        """Carry the source's slice-geometry tags into the output."""
        thickness = LDCTDataset._meta_float(metadata, "Slice Thickness", "SliceThickness")
        if thickness is not None:
            ds.SliceThickness = thickness
        between = LDCTDataset._meta_float(metadata, "Spacing Between Slices", "SpacingBetweenSlices")
        if between is not None:
            ds.SpacingBetweenSlices = between
        spacing = LDCTDataset._parse_pixel_spacing(
            metadata.get("Pixel Spacing", metadata.get("PixelSpacing")))
        if spacing is not None:
            ds.PixelSpacing = spacing

    @staticmethod
    def _parse_pixel_spacing(value):
        """A 2-list or a string like "[0.7\\0.7]" as the 2-element string
        list pydicom expects."""
        if isinstance(value, str):
            for ch in "[]()":
                value = value.replace(ch, "")
            parts = [p.strip() for p in value.replace("\\", ",").split(",") if p.strip()]
            if len(parts) >= 2:
                return [str(float(parts[0])), str(float(parts[1]))]
            return None
        if isinstance(value, (list, tuple)) and len(value) >= 2:
            return [str(float(value[0])), str(float(value[1]))]
        return None

    @staticmethod
    def _meta_float(meta: dict, *keys: str):
        """The first of ``keys`` whose value parses as a float, else None."""
        for value in filter(lambda v: v is not None, map(meta.get, keys)):
            try:
                return float(value)
            except (TypeError, ValueError):
                pass
        return None


class LDCTAttentionDataset(LDCTDataset):
    """LDCT whose conditioning entries (precomputed VAE latents) skip the HU
    preprocessing."""

    def _load_conditioning_tensor(self, row: dict, item_id):
        if self.conditioning_key is None:
            raise KeyError("Conditioning requested but no conditioning column provided.")
        return self._load_entry_tensor(row, item_id, self.conditioning_key, preprocess=False)


def build_ldct_from_config(training_cfg: dict, _model_cfg, train: bool):
    """An LDCTDataset from a training config."""
    return LDCTDataset(
        str(Path(training_cfg["data_root"])),
        train=train,
        img_size=training_cfg.get("img_size"),
        window_size=training_cfg.get("window_size", training_cfg.get("slice_count", 1)),
        norm=training_cfg.get("norm", True),
        load_ldct=bool(training_cfg.get("load_ldct", False)),
        use_tensor_cache=bool(training_cfg.get("use_tensor_cache", True)),
        save_tensor_cache=bool(training_cfg.get("save_tensor_cache", False)),
        cache_subdir=training_cfg.get("tensor_cache_subdir", "cache"),
        preprocess_kwargs=training_cfg.get("preprocess_kwargs"),
    )
