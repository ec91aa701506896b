"""Image display utilities (equivalent of ``src/util/visualization.{h,cpp}``).

The reference offers an interactive OpenCV window with drag-to-zoom
(``visualization.cpp:58-136``); :class:`ZoomInteraction` reproduces that
state machine (left-drag draws a selection rectangle and zooms in on
release, right-click zooms back out, an interrupted drag cancels) with the
rendering callback injected so the logic is unit-testable without a
display. In headless environments (the norm for accelerator hosts) display falls
back to writing PNG files and reporting their paths.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

# OpenCV is imported inside the functions that use it: the package, the
# solver and the CLI on ENVI input run without it.

__all__ = [
    "display_image",
    "display_images_side_by_side",
    "ZoomInteraction",
]

_MAX_DISPLAY_W = 1250
_MAX_DISPLAY_H = 850
_SELECTION_COLOR = (0, 255, 255)  # yellow, like the reference
_SELECTION_THICKNESS = 1


class ZoomInteraction:
    """Mouse-driven zoom state machine (``visualization.cpp:58-136``).

    Events arrive via :meth:`on_mouse` with OpenCV event codes; ``show`` is
    the injected render callback (``cv2.imshow`` in production). Behavior:

    - left-press (not zoomed): start a drag; while dragging, the current
      selection rectangle is drawn over the image.
    - left-release: crop to the selection, rescale it to fit the display
      bounds, and show it (now zoomed in).
    - a drag whose left button is no longer held (mouse left the window)
      cancels and restores the original.
    - right-press while zoomed: restore the original image.
    """

    def __init__(self, image: np.ndarray, show):
        self.image = image
        self._show = show
        self.drag_start = (0, 0)
        self.dragging = False
        self.zoomed = False

    def on_mouse(self, event: int, x: int, y: int, flags: int = 0) -> None:
        import cv2

        if event == cv2.EVENT_RBUTTONDOWN and self.zoomed:
            self._show(self.image)
            self.zoomed = False
        if event == cv2.EVENT_LBUTTONDOWN and not self.zoomed:
            self.drag_start = (x, y)
            self.dragging = True
        if self.dragging and event != cv2.EVENT_LBUTTONDOWN and not (
            flags & cv2.EVENT_FLAG_LBUTTON
        ) and event != cv2.EVENT_LBUTTONUP:
            self._show(self.image)
            self.dragging = False
        if event == cv2.EVENT_LBUTTONUP and self.dragging:
            x0, y0 = self.drag_start
            left, top = min(x, x0), min(y, y0)
            w, h = abs(x - x0), abs(y - y0)
            if w > 0 and h > 0:
                crop = self.image[top : top + h, left : left + w]
                scale = min(_MAX_DISPLAY_W / w, _MAX_DISPLAY_H / h)
                crop = cv2.resize(
                    crop, (max(1, int(w * scale)), max(1, int(h * scale)))
                )
                self._show(crop)
                self.zoomed = True
            self.dragging = False
        elif self.dragging:
            overlay = self.image.copy()
            cv2.rectangle(
                overlay, self.drag_start, (x, y),
                _SELECTION_COLOR, _SELECTION_THICKNESS,
            )
            self._show(overlay)


def _fit(image: np.ndarray) -> np.ndarray:
    import cv2

    h, w = image.shape[:2]
    scale = min(_MAX_DISPLAY_W / w, _MAX_DISPLAY_H / h, 1.0)
    if scale < 1.0:
        image = cv2.resize(image, (int(w * scale), int(h * scale)))
    return image


def _vis(image) -> np.ndarray:
    if hasattr(image, "visualization_image"):
        return image.visualization_image()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY"))


def _show_or_save(image: np.ndarray, title: str) -> str | None:
    import cv2

    if _has_display():
        try:
            cv2.namedWindow(title, cv2.WINDOW_AUTOSIZE)
            interaction = ZoomInteraction(
                image, lambda img: cv2.imshow(title, img)
            )
            cv2.setMouseCallback(
                title,
                lambda event, x, y, flags, _: interaction.on_mouse(
                    event, x, y, flags
                ),
            )
            cv2.imshow(title, image)
            print("Displaying image. Press any key to continue.")
            cv2.waitKey(0)
            cv2.destroyWindow(title)
            return None
        except cv2.error:
            pass
    path = os.path.join(
        tempfile.gettempdir(), f"{title.lower().replace(' ', '_').replace('.', '')}.png"
    )
    cv2.imwrite(path, image)
    print(f"[headless] saved '{title}' to {path}")
    return path


def display_image(image, title: str = "Image") -> str | None:
    return _show_or_save(_fit(_vis(image)), title)


def display_images_side_by_side(images, title: str = "Images") -> str | None:
    """Horizontal stitch (``visualization.cpp:138-169``); smaller images are
    padded to the tallest height."""
    import cv2

    mats = [_vis(img) for img in images]
    max_h = max(m.shape[0] for m in mats)
    padded = []
    for m in mats:
        if m.ndim == 2:
            m = cv2.cvtColor(m, cv2.COLOR_GRAY2BGR)
        pad = max_h - m.shape[0]
        if pad:
            m = cv2.copyMakeBorder(m, 0, pad, 0, 0, cv2.BORDER_CONSTANT, value=0)
        padded.append(m)
    stitched = np.concatenate(padded, axis=1)
    return _show_or_save(_fit(stitched), title)
