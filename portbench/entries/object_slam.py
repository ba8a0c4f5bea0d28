"""ObjectSlamTracker, CubeSLAM's monocular object SLAM: per frame the grey
image, the frame's 2D box and the LSD lines of the frame, which the feed
computes on the device as part of the frame's work (`lines_fn(gray tensor)
-> (M, 4) numpy` replaces the port's LSD for the control and the tests)."""

from ..drive import GrayFeed, port_lines_fn


def build(port, cfg, ep, device):
    from cube_slam_tpu_torch.slam.system import ObjectSlamTracker, TrackerConfig

    return ObjectSlamTracker(ep.K, ep.wh, TrackerConfig(**cfg["tracker"]), ground_Twc0=ep.truth_Twc[0], device=device)


class Feed(GrayFeed):
    def __init__(self, port, cfg, ep, device, lines_fn=None):
        import torch

        super().__init__(port, cfg, ep, device)
        self.torch = torch
        self.boxes = ep.boxes
        self.lines_fn = lines_fn if lines_fn is not None else port_lines_fn(port, cfg)

    def args(self, f):
        lines = self.lines_fn(self.torch.as_tensor(self.gray[f], device=self.device))
        return (self.gray[f], self.boxes[f], lines), {"lines": lines}
