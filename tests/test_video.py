"""Video loader + video super-resolver tests."""

import os

import cv2
import numpy as np
import pytest

from super_resolution_tpu.video import VideoLoader, VideoSuperResolver


@pytest.fixture()
def frame_dir(tmp_path, seeded_data_dir):
    img = cv2.imread(f"{seeded_data_dir}/fb.png", cv2.IMREAD_GRAYSCALE)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(4):
        cv2.imwrite(str(d / f"frame_{i}.png"), np.roll(img, i, axis=1))
    return str(d)


def test_load_frames_from_directory(frame_dir):
    loader = VideoLoader()
    loader.load_frames_from_directory(frame_dir)
    assert loader.num_frames == 4
    assert loader.image_size == (28, 28)
    stack = loader.frame_stack()
    assert stack.shape == (4, 1, 28, 28)
    assert 0.0 <= stack.min() and stack.max() <= 1.0


def test_load_frames_from_video(tmp_path, seeded_data_dir):
    img = cv2.imread(f"{seeded_data_dir}/fb.png", cv2.IMREAD_COLOR)
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, (28, 28))
    for i in range(6):
        writer.write(np.roll(img, i, axis=0))
    writer.release()
    loader = VideoLoader()
    loader.load_frames_from_video(path, max_frames=5)
    assert loader.num_frames == 5
    assert loader.image_size == (28, 28)


def test_video_super_resolver(frame_dir):
    loader = VideoLoader()
    loader.load_frames_from_directory(frame_dir)
    frames = loader.frame_stack()
    resolver = VideoSuperResolver(scale=2, temporal_window=3, blur_radius=0)
    out = resolver.super_resolve_frame(frames, 1)
    assert out.shape == (1, 56, 56)
    assert np.isfinite(out).all()


def test_play_original_video_headless(frame_dir, monkeypatch):
    """PlayOriginalVideo parity (video_loader.cpp:62-77): headless runs write
    the 1000x600-resized frames instead of opening a window."""
    monkeypatch.delenv("DISPLAY", raising=False)
    loader = VideoLoader()
    loader.load_frames_from_directory(frame_dir)
    paths = loader.play_original_video()
    assert paths is not None and len(paths) == 4
    frame = cv2.imread(paths[0])
    assert frame.shape[:2] == (600, 1000)


def test_video_super_resolver_with_motion_refinement(frame_dir):
    """Video sliding windows + refine_motion_every: each window's estimated
    motion is refined against its evolving HR estimate; options pass through
    VideoSuperResolver untouched (the refiner executable is cached
    module-wide across the per-window solver instances)."""
    from super_resolution_tpu.solvers import IRLSMapSolverOptions

    loader = VideoLoader()
    loader.load_frames_from_directory(frame_dir)
    frames = loader.frame_stack()
    opts = IRLSMapSolverOptions(
        max_num_irls_iterations=2, max_num_solver_iterations=6,
        refine_motion_every=1,
    )
    resolver = VideoSuperResolver(
        scale=2, temporal_window=3, blur_radius=3, blur_sigma=0.7,
        solver_options=opts,
    )
    out = resolver.super_resolve(frames)
    assert out.shape == (4, 1, 56, 56)
    assert np.isfinite(out).all()
