"""Unified typed configuration.

A host copy of cube_slam_tpu/config.py (numpy only): the same dataclasses,
defaults, `from_overrides` and per-scene presets.

The reference spreads configuration over three tiers (SURVEY 5): ROS params
-> mutable globals (Parameters.{h,cpp}), OpenCV FileStorage YAMLs for
camera/ORB/viewer settings (Tracking.cc:120-196), and hard-coded constants.
Here everything is one dataclass tree with per-scene presets; YAML-ish
loading is a flat dict override.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict

import numpy as np


@dataclass
class CameraConfig:
    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    width: int = 640
    height: int = 480
    fps: float = 10.0

    @property
    def K(self):
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )


@dataclass
class OrbConfig:
    """ORB settings block (Examples/Monocular/*.yaml)."""

    n_features: int = 1500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0


@dataclass
class ObjectConfig:
    """Object flags (Parameters.h:28-70 subset that affects behavior)."""

    whether_detect_object: bool = False
    whether_read_offline_cuboidtxt: bool = False
    camera_object_BA_weight: float = 1.0
    whether_dynamic_object: bool = False
    mono_allow_obj_depth_init: bool = True
    kitti_car_prior_scale: tuple = (1.9420, 0.8143, 0.7631)  # Optimizer.cc:994


@dataclass
class GroundScaleConfig:
    enabled: bool = False
    nominal_height: float = 1.7
    every_kfs: int = 10


@dataclass
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    objects: ObjectConfig = field(default_factory=ObjectConfig)
    ground: GroundScaleConfig = field(default_factory=GroundScaleConfig)
    parallel_mapping: bool = False  # sequential deterministic schedule
    enable_loop_closing: bool = False

    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_overrides(cls, **flat):
        """Build from 'section.key' overrides, e.g. camera.fx=700."""
        cfg = cls()
        for key, value in flat.items():
            section, _, name = key.partition(".")
            target = getattr(cfg, section)
            if not hasattr(target, name):
                raise KeyError(f"unknown config key {key}")
            setattr(target, name, value)
        return cfg


# per-scene presets (the launch-file tier)
def tum_cabinet_config():
    return SlamConfig()


def kitti_config():
    return SlamConfig(
        camera=CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                            width=1241, height=376, fps=10.0),
        orb=OrbConfig(n_features=3000),
        objects=ObjectConfig(whether_detect_object=True,
                             whether_read_offline_cuboidtxt=True),
        ground=GroundScaleConfig(enabled=True),
    )
