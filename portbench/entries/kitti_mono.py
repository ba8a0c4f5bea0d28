"""KittiMonoTracker, CubeSLAM's KITTI monocular mode: the offline cuboid
rows with tracklet ids once, at construction, then the grey image per
frame."""

from ..drive import GrayFeed as Feed  # noqa: F401


def build(port, cfg, ep, device):
    from cube_slam_tpu_torch.slam.ground import GroundConfig
    from cube_slam_tpu_torch.slam.kitti import KittiMonoTracker
    from cube_slam_tpu_torch.slam.system import TrackerConfig

    ground = GroundConfig(nominal_height=float(abs(ep.truth_Twc[0][2, 3])), **cfg["ground"])
    return KittiMonoTracker(ep.K, ep.wh, ep.offline_rows(), ep.truth_Twc[0], config=TrackerConfig(**cfg["tracker"]),
                            car_prior=ep.box_half, ground_cfg=ground, device=device)
