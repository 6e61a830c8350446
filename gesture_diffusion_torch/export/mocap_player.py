"""Interactive notebook mocap player: one self-contained HTML document.

Port of ``gesture_diffusion_tpu/export/mocap_player.py`` (a copy: the
module is standard library and numpy only), the counterpart of the
reference's ``datasets/pymo/viz_tools.py:192-235`` (``nb_play_mocap``).
The reference templates its position CSV into a ``data.js`` beside a
three.js ``mocapplayer/playBuffer.html`` that its repository does not
ship, so its function renders nothing as checked in (it also fails with
``NameError: data_assigned`` for ``mf='bvh'``, and its rotation-column
filter removes from the list while iterating over it, skipping every
second column).  This module keeps the reference's signature but inlines
everything: the position data, the skeleton's edges, optional per-frame
metadata, and a small canvas renderer with play/pause and a frame slider,
so the page needs no external asset or network.  IPython is imported only
when ``nb_play_mocap`` is called, and is optional.
"""

import html as _html
import json
import os
from typing import Optional

__all__ = ["nb_play_mocap", "render_mocap_player_html"]

_PLAYER_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><style>
body{margin:0;font:12px sans-serif;background:#111;color:#ddd}
#bar{padding:6px;display:flex;gap:8px;align-items:center}
#frame{flex:1}
canvas{display:block;background:#181818}
#meta{padding:2px 6px;color:#9c9;white-space:pre}
</style></head><body>
<div id="bar">
  <button id="play">&#9654;</button>
  <input id="frame" type="range" min="0" value="0">
  <span id="label"></span>
</div>
<div id="meta"></div>
<canvas id="cv" width="960" height="420"></canvas>
<script>
var joints = $$JOINTS$$;      // [name, ...] in column order
var edges = $$EDGES$$;        // [[parentIdx, childIdx], ...]
var frames = $$DATA$$;        // [T][J*3] xyz per joint
var metadata = $$META$$;      // [] or [T][...] per-frame rows
var frameTime = $$FRAMETIME$$, scale = $$SCALE$$, cameraZ = $$CZ$$;
var cv = document.getElementById('cv'), ctx = cv.getContext('2d');
var slider = document.getElementById('frame'), label = document.getElementById('label');
var metaDiv = document.getElementById('meta'), playBtn = document.getElementById('play');
var T = frames.length, J = joints.length, cur = 0, playing = false, timer = null;
slider.max = Math.max(0, T - 1);
// center/extent from frame 0 so the figure fills the canvas
var c0 = frames[0] || [], cx = 0, cy = 0, ext = 1;
for (var j = 0; j < J; j++) { cx += c0[3*j]; cy += c0[3*j+1]; }
cx /= Math.max(1, J); cy /= Math.max(1, J);
for (var j = 0; j < J; j++) {
  ext = Math.max(ext, Math.abs(c0[3*j]-cx), Math.abs(c0[3*j+1]-cy));
}
function proj(x, y, z) {
  // simple perspective along +Z with the camera at cameraZ
  var f = cameraZ / Math.max(1e-6, cameraZ + z);
  var s = scale * f * 0.42 * Math.min(cv.width, cv.height) / ext;
  return [cv.width/2 + (x - cx) * s, cv.height/2 - (y - cy) * s];
}
function draw(t) {
  ctx.clearRect(0, 0, cv.width, cv.height);
  var fr = frames[t]; if (!fr) return;
  ctx.strokeStyle = '#8ab4f8'; ctx.lineWidth = 2;
  for (var e = 0; e < edges.length; e++) {
    var a = edges[e][0], b = edges[e][1];
    var p = proj(fr[3*a], fr[3*a+1], fr[3*a+2]);
    var q = proj(fr[3*b], fr[3*b+1], fr[3*b+2]);
    ctx.beginPath(); ctx.moveTo(p[0], p[1]); ctx.lineTo(q[0], q[1]); ctx.stroke();
  }
  ctx.fillStyle = '#e8eaed';
  for (var j = 0; j < J; j++) {
    var p = proj(fr[3*j], fr[3*j+1], fr[3*j+2]);
    ctx.beginPath(); ctx.arc(p[0], p[1], 3, 0, 6.2832); ctx.fill();
  }
  label.textContent = t + '/' + (T - 1);
  metaDiv.textContent = metadata.length ? String(metadata[t]) : '';
}
function setFrame(t) { cur = (t + T) % T; slider.value = cur; draw(cur); }
slider.oninput = function () { setFrame(+slider.value); };
playBtn.onclick = function () {
  playing = !playing;
  playBtn.innerHTML = playing ? '&#10074;&#10074;' : '&#9654;';
  if (playing) timer = setInterval(function () { setFrame(cur + 1); },
                                   frameTime * 1000);
  else clearInterval(timer);
};
draw(0);
</script></body></html>
"""


def render_mocap_player_html(track, meta=None, frame_time: float = 1 / 30,
                             scale: float = 1.0, camera_z: float = 500.0):
    """Build the standalone player HTML for a POSITION-parameterised
    ``BvhData`` track (``MocapParameterizer('position')`` output).

    ``meta`` mirrors the reference: an optional ``(T, k)`` array whose
    row for the current frame is shown under the controls."""
    import numpy as np

    cols = {name: i for i, name in enumerate(track.column_names)}
    joints = [j for j in track.joints
              if f"{j}_Xposition" in cols and f"{j}_Yposition" in cols
              and f"{j}_Zposition" in cols]
    if not joints:
        raise ValueError(
            "track has no *_{X,Y,Z}position columns — run "
            "MocapParameterizer('position') first")
    jidx = {j: i for i, j in enumerate(joints)}
    edges = [[jidx[j], jidx[c]]
             for j in joints for c in track.joints[j].children if c in jidx]
    vals = np.asarray(track.values, dtype=np.float64)
    data = np.empty((vals.shape[0], 3 * len(joints)), dtype=np.float64)
    for j, i in jidx.items():
        for a, off in (("X", 0), ("Y", 1), ("Z", 2)):
            data[:, 3 * i + off] = vals[:, cols[f"{j}_{a}position"]]
    meta_rows = ([] if meta is None
                 else [",".join(map(str, row)) for row in np.asarray(meta)])
    out = _PLAYER_TEMPLATE
    for key, val in (
        ("$$JOINTS$$", json.dumps(joints)),
        ("$$EDGES$$", json.dumps(edges)),
        ("$$DATA$$", json.dumps(np.round(data, 4).tolist())),
        ("$$META$$", json.dumps(meta_rows)),
        ("$$FRAMETIME$$", repr(float(frame_time))),
        ("$$SCALE$$", repr(float(scale))),
        ("$$CZ$$", repr(float(camera_z))),
    ):
        out = out.replace(key, val)
    return out


class _HtmlShim:
    """Notebook-displayable fallback when IPython is absent."""

    def __init__(self, data: str):
        self.data = data

    def _repr_html_(self) -> str:
        return self.data

    def __str__(self) -> str:
        return self.data


def nb_play_mocap(mocap, mf: str = "pos", meta=None,
                  frame_time: float = 1 / 30, scale: float = 1.0,
                  camera_z: float = 500.0,
                  base_url: Optional[str] = None):
    """Inline notebook player for a position-parameterised mocap track —
    reference ``viz_tools.py:192-235``, same signature.

    Deviations (documented): the player is fully self-contained (the
    reference's external ``mocapplayer/playBuffer.html`` three.js assets
    are not shipped in its repo, so its function renders a dead iframe);
    ``mf='bvh'`` raises a clear error instead of the reference's
    ``NameError`` (its branch is ``pass``); rotation columns are excluded
    correctly (the reference's remove-while-iterating filter drops only
    every second one).  ``base_url``, if given, is treated as an output
    path: the HTML is written there and the returned object iframes the
    file instead of inlining it via ``srcdoc``."""
    if mf != "pos":
        raise ValueError(
            f"mf={mf!r} unsupported: only 'pos' renders (the reference's "
            "'bvh' branch is a NameError defect, viz_tools.py:204)")
    page = render_mocap_player_html(
        mocap, meta=meta, frame_time=frame_time, scale=scale,
        camera_z=camera_z)
    if base_url is not None:
        # declared <meta charset="utf-8">: write it that way regardless of
        # the host locale (C/cp1252 would crash or mojibake joint names)
        with open(base_url, "w", encoding="utf-8") as f:
            f.write(page)
        # iframe src must stay RELATIVE to the notebook dir: the Jupyter
        # server serves files by relative URL, while an absolute filesystem
        # path resolves against the server origin (404) and file:// is
        # blocked from http pages.  Fall back to the name if the path is
        # on another drive (Windows relpath raises).
        try:
            rel = os.path.relpath(base_url)
        except ValueError:
            rel = os.path.basename(base_url)
        src = f'src="{_html.escape(rel)}"'
        link = (f'<a href="{_html.escape(rel)}" '
                'target="_blank">New Window</a>')
    else:
        src = f'srcdoc="{_html.escape(page, quote=True)}"'
        link = ""
    doc = (f'<iframe frameborder="0" {src} width="100%" height="520">'
           f"</iframe>{link}")
    try:
        import IPython.display
        return IPython.display.HTML(doc)
    except ImportError:
        return _HtmlShim(doc)
