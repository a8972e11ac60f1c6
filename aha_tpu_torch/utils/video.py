"""Vision parts of a chat request (the port's copy of
aha_tpu/utils/video.py's `extract_vision_parts`).  Video decoding — the
container reader, frame sampling and the temporal M-RoPE interval
(`second_per_grid_ts`) — is not ported: a served model raises on a video
part (VIDEO_NOT_PORTED) rather than drop it."""

from __future__ import annotations

VIDEO_NOT_PORTED = (
    "video input is not ported to aha_tpu_torch yet: it needs the video "
    "container decoding, frame sampling and second_per_grid_ts of "
    "aha_tpu/utils/video.py")


def extract_vision_parts(mes) -> list[tuple[str, str]]:
    """[(kind, url)] in prompt order; kind in {"image", "video"}."""
    out = []
    for m in mes.messages:
        parts = m.content if isinstance(m.content, list) else []
        for p in parts:
            if getattr(p, "image_url", None) is not None:
                out.append(("image", p.image_url.url))
            elif getattr(p, "video_url", None) is not None:
                out.append(("video", p.video_url.url))
    return out
