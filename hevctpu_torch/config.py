"""Typed, layered encoder configuration (port of hevctpu/config.py).

The reference's app shell reads its options through program_options_lite:
options are declared once with names, types and defaults
(TAppEncCfg.cpp:731), any number of ``-c file.cfg`` files are parsed in
order (``Key : Value  # comment`` grammar, program_options_lite.cpp:453,551)
and command-line flags override last. The shipped run layers two files:
the codec config (encoder_intra_main.cfg) and the sequence config.

This is that system as one dataclass: every knob the encoder exposes lives
here with an HM-compatible option name, ``load()`` applies cfg files left
to right then explicit overrides, and the result fans out to the runtime
objects (`to_stream_config`, `encoder_kwargs`, `make_encoder`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# The reference pipeline's checkpoint file name. It is not shipped with the
# repository: pass --model (a .pt state dict or an .npz params file) or
# --fixed-depth.
DEFAULT_MODEL = "hevc_encoder_model.pt"


@dataclasses.dataclass
class EncoderConfig:
    # --- sequence (bitstream.cfg layer) ---
    input_file: str = ""
    source_width: int = 0
    source_height: int = 0
    frame_rate: float = 30.0
    frames_to_be_encoded: int = 0
    bitstream_file: str = ""
    recon_file: str = ""
    # --- codec operating point (encoder_intra_main.cfg layer) ---
    qp: int = 32
    rdoq: bool = True                 # RDOQ          (TComTrQuant RDOQ path)
    rdoq_ts: bool = True              # RDOQTS
    transform_skip: bool = True       # TransformSkip
    sign_data_hiding: bool = True     # SignHideFlag
    sao: bool = True                  # SAO
    deblock: bool = True              # !LoopFilterDisable
    max_tu_depth_intra: int = 3       # QuadtreeTUMaxDepthIntra
    nxn: bool = True                  # PART_NxN at max CU depth
    strong_intra_smoothing: bool = True  # StrongIntraSmoothing
    # --- pipeline (replaces the reference's gen_frames/use_model glue) ---
    search: str = "cnn"               # cnn (pruned) | rd (full search)
    model: str = DEFAULT_MODEL        # ConvNet2 checkpoint (.pt or .npz)
    fixed_depth: Optional[int] = None  # bypass CNN with a constant depth
    batch: int = 4                    # frames per device step
    target_kbps: float = 0.0          # >0 enables R-lambda rate control
    lcu_rc: bool = False              # LCU-level R-lambda (cu_qp_delta)
    wpp: bool = False                 # entropy_coding_sync (WPP) substreams
    adaptive_qp: bool = False         # TM5-step-3 preanalysis QP offset
    hash_type: str = "md5"            # DecodedPictureHashSEI type
    rate_model: str = "global"        # search rate estimator: global | ctx

    def __post_init__(self):
        if self.search not in ("cnn", "rd"):
            raise ValueError(f"search must be cnn|rd, got {self.search!r}")
        if self.hash_type not in ("md5", "crc", "checksum", "none"):
            raise ValueError(
                f"hash_type must be md5|crc|checksum|none, "
                f"got {self.hash_type!r}")
        if self.rate_model not in ("ctx", "global"):
            raise ValueError(
                f"rate_model must be ctx|global, got {self.rate_model!r}")
        if not 0 <= self.qp <= 51:
            raise ValueError(f"QP out of range: {self.qp}")
        if not 0 <= self.max_tu_depth_intra <= 3:
            raise ValueError(
                f"QuadtreeTUMaxDepthIntra out of range: "
                f"{self.max_tu_depth_intra}")

    # -- fan-out to the runtime objects -----------------------------------

    def to_stream_config(self, qp: Optional[int] = None):
        """The bitstream-level view (SPS/PPS/slice-header fields)."""
        from hevctpu_torch.codec import headers

        return headers.StreamConfig(
            width=self.source_width, height=self.source_height,
            qp=self.qp if qp is None else qp,
            strong_intra_smoothing=self.strong_intra_smoothing,
            sign_data_hiding=self.sign_data_hiding,
            max_tu_depth_intra=self.max_tu_depth_intra,
            transform_skip=self.transform_skip,
            deblock=self.deblock, sao=self.sao,
            hash_type=self.hash_type,
            cu_qp_delta=self.lcu_rc and self.target_kbps > 0,
            wpp=self.wpp)

    def encoder_kwargs(self) -> dict:
        """Keyword arguments for FrameEncoder(h, w, qp, **kwargs)."""
        return dict(search=self.search, rdoq=self.rdoq, sao=self.sao,
                    deblock=self.deblock, sbh=self.sign_data_hiding,
                    nxn=self.nxn, tu_split=self.max_tu_depth_intra > 0,
                    ts=self.transform_skip, rate_model=self.rate_model)

    def make_encoder(self, qp: Optional[int] = None, device=None):
        """The port's FrameEncoder for this config on `device` (the card
        unless the caller names another)."""
        from hevctpu_torch.pipeline.encoder import FrameEncoder

        return FrameEncoder(self.source_height, self.source_width,
                            self.qp if qp is None else qp, device=device,
                            **self.encoder_kwargs())


def _to_bool(v: str) -> bool:
    return bool(int(v))


# HM option name -> (dataclass field, parse). Names follow TAppEncCfg.cpp
# where the option exists there; pipeline-only knobs use our own names.
# WaveFrontSynchro appears twice, as in the JAX package: the second entry
# (the wpp field) is the one the dict keeps.
OPTION_MAP = {
    "InputFile": ("input_file", str),
    "SourceWidth": ("source_width", int),
    "SourceHeight": ("source_height", int),
    "FrameRate": ("frame_rate", float),
    "FramesToBeEncoded": ("frames_to_be_encoded", int),
    "FrameSkip": (None, None),            # accepted, unused (always 0)
    "InputBitDepth": (None, None),        # 8-bit only (validated below)
    "InputChromaFormat": (None, None),    # 4:2:0 only (validated below)
    "Level": (None, None),
    "Profile": (None, None),
    "BitstreamFile": ("bitstream_file", str),
    "ReconFile": ("recon_file", str),
    "QP": ("qp", int),
    "RDOQ": ("rdoq", _to_bool),
    "RDOQTS": ("rdoq_ts", _to_bool),
    "TransformSkip": ("transform_skip", _to_bool),
    "TransformSkipFast": (None, None),
    "SignHideFlag": ("sign_data_hiding", _to_bool),
    "SAO": ("sao", _to_bool),
    "LoopFilterDisable": ("deblock", lambda v: not _to_bool(v)),
    "QuadtreeTUMaxDepthIntra": ("max_tu_depth_intra", int),
    "StrongIntraSmoothing": ("strong_intra_smoothing", _to_bool),
    # HM options pinned by this encoder's All-Intra design: accepted when
    # they match the supported value, rejected otherwise.
    "MaxCUWidth": (None, ("==", 64)),
    "MaxCUHeight": (None, ("==", 64)),
    "MaxPartitionDepth": (None, ("==", 4)),
    "QuadtreeTULog2MaxSize": (None, ("==", 5)),
    "QuadtreeTULog2MinSize": (None, ("==", 2)),
    "IntraPeriod": (None, ("==", 1)),
    "GOPSize": (None, ("==", 1)),
    "SliceMode": (None, ("==", 0)),
    "WaveFrontSynchro": (None, ("==", 0)),  # noqa: F601 (overridden below)
    # pipeline layer (no HM counterpart)
    "Search": ("search", str),
    "Model": ("model", str),
    "FixedDepth": ("fixed_depth", int),
    "Batch": ("batch", int),
    "TargetKbps": ("target_kbps", float),
    # HM's LCULevelRateControl (TEncRateCtrl.cpp:845 getLCUEstLambda)
    "LCULevelRateControl": ("lcu_rc", _to_bool),
    # HM's WaveFrontSynchro (entropy_coding_sync_enabled_flag)
    "WaveFrontSynchro": ("wpp", _to_bool),  # noqa: F601
    "AdaptiveQP": ("adaptive_qp", _to_bool),
    # DecodedPictureHash SEI type: HM signals 1=MD5 via DecodedPictureHash
    # (TAppEncCfg); we take the name directly.
    "HashType": ("hash_type", str),
    "RateModel": ("rate_model", str),
}


class ConfigError(ValueError):
    pass


def apply_cfg_file(values: dict, path: str) -> dict:
    """Parse one HM-grammar cfg file into dataclass-field updates."""
    from hevctpu_torch.pipeline import yuv

    raw = yuv.parse_hm_cfg(path)
    for key, val in raw.items():
        if key not in OPTION_MAP:
            raise ConfigError(f"{path}: unknown option {key!r}")
        field, parse = OPTION_MAP[key]
        if field is None:
            if isinstance(parse, tuple) and parse[0] == "==":
                if int(val) != parse[1]:
                    raise ConfigError(
                        f"{path}: {key} = {val} unsupported "
                        f"(this encoder is fixed at {parse[1]})")
            elif key == "InputBitDepth" and int(val) != 8:
                raise ConfigError(f"{path}: only 8-bit input supported")
            elif key == "InputChromaFormat" and int(val) != 420:
                raise ConfigError(f"{path}: only 4:2:0 supported")
            continue
        try:
            values[field] = parse(val)
        except (TypeError, ValueError) as e:
            raise ConfigError(f"{path}: bad value for {key}: {val!r} ({e})")
    return values


def load(cfg_paths=(), **overrides) -> EncoderConfig:
    """Layered load: defaults <- cfg files (in order) <- overrides.

    Mirrors program_options_lite's precedence (multiple -c files parsed
    in order, CLI last; program_options_lite.cpp:551)."""
    values: dict = {}
    for p in cfg_paths:
        apply_cfg_file(values, p)
    for k, v in overrides.items():
        if v is not None:
            values[k] = v
    if values.get("input_file"):
        values["input_file"] = values["input_file"].replace("\\", "/")
    try:
        return EncoderConfig(**values)
    except (TypeError, ValueError) as e:
        raise ConfigError(str(e))
