"""Video frame loading (equivalent of ``src/video/video_loader.{h,cpp}``).

Supports frame extraction from video files (cv2.VideoCapture) and from image
directories (the only path the reference actually exercises,
``shift_add_fusion.cpp:37-38``). Frames come back as a ``[K, C, H, W]`` float
stack ready for the fusion/solver pipelines.
"""

from __future__ import annotations

import os

import numpy as np

# OpenCV is imported inside the functions that use it: the package, the
# solver and the CLI on ENVI input run without it.

__all__ = ["VideoLoader"]


class VideoLoader:
    def __init__(self):
        self._frames: list[np.ndarray] = []  # HWC float64 in [0, 1]

    def load_frames_from_video(self, video_path: str, max_frames: int = 0) -> None:
        import cv2

        capture = cv2.VideoCapture(video_path)
        if not capture.isOpened():
            raise FileNotFoundError(f"Could not open video {video_path}")
        self._frames = []
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            self._frames.append(frame.astype(np.float64) / 255.0)
            if max_frames and len(self._frames) >= max_frames:
                break
        capture.release()

    def load_frames_from_directory(self, directory: str) -> None:
        from super_resolution_tpu.utils.data_loader import load_images

        images = [np.moveaxis(np.asarray(img.hidden_array), 0, -1)
                  for img in load_images(directory)]
        self._frames = images

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    @property
    def image_size(self) -> tuple[int, int]:
        """(width, height) of the frames."""
        if not self._frames:
            return (0, 0)
        h, w = self._frames[0].shape[:2]
        return (w, h)

    def get_frames(self) -> list[np.ndarray]:
        return list(self._frames)

    def frame_stack(self) -> np.ndarray:
        """``[K, C, H, W]`` float stack."""
        if not self._frames:
            return np.zeros((0, 0, 0, 0))
        return np.stack([np.moveaxis(f, -1, 0) if f.ndim == 3 else f[None]
                         for f in self._frames])

    def play_original_video(self, frame_delay_ms: int = 30) -> list[str] | None:
        """Play the loaded frames in a window (``video_loader.cpp:62-77``):
        each frame resized to the reference's 1000x600 display size, ~30 ms
        apart, stopping early on any keypress. Headless (no $DISPLAY): the
        resized frames are written to a temp directory instead and the paths
        returned (None when displayed interactively)."""
        import cv2

        import tempfile

        display_size = (1000, 600)  # kDisplayFrameSize, video_loader.cpp:19
        frames8 = [
            cv2.resize(
                (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8), display_size
            )
            for f in self._frames
        ]
        if os.environ.get("DISPLAY"):
            try:
                window_name = "Original Video"
                cv2.namedWindow(window_name)
                for frame in frames8:
                    cv2.imshow(window_name, frame)
                    if cv2.waitKey(frame_delay_ms) >= 0:
                        break
                cv2.destroyWindow(window_name)
                return None
            except cv2.error:
                pass
        out_dir = tempfile.mkdtemp(prefix="srtpu_video_")
        paths = []
        for i, frame in enumerate(frames8):
            path = os.path.join(out_dir, f"frame_{i:05d}.png")
            cv2.imwrite(path, frame)
            paths.append(path)
        if paths:
            print(f"[headless] saved {len(paths)} video frames to {out_dir}")
        return paths
