"""BVH parsing and writing, dependency-free (no pandas).

A copy of ``gesture_diffusion_tpu/data/bvh.py`` (numpy only), kept here so
the port never imports the JAX package: one linear tokenizer, a flat joint
table in file order, and motion frames as a single (T, C) float array with
"{joint}_{channel}" column names.  The writer regenerates the hierarchy
text from the joint table.  The MOTION block's floats are parsed by the
port's native strtod parser (``native.parse_floats``, built with g++ at
first use), as the JAX package parses them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..native import parse_floats

_TOKEN = re.compile(r"[^\s{}:]+|\{|\}")  # ':' dropped ("Frames:" -> "Frames")


@dataclasses.dataclass
class BvhJoint:
    name: str
    parent: Optional[str]
    offset: np.ndarray                 # (3,)
    channels: List[str]                # [] for End Sites
    order: str                         # e.g. "XYZ" for rotation channels
    children: List[str] = dataclasses.field(default_factory=list)
    is_end_site: bool = False


@dataclasses.dataclass
class BvhData:
    joints: Dict[str, BvhJoint]        # insertion order == file order
    root_name: str
    framerate: float                   # seconds per frame
    values: np.ndarray                 # (T, C)
    channel_names: List[Tuple[str, str]]   # [(joint, channel)] in column order

    @property
    def column_names(self) -> List[str]:
        return [f"{j}_{c}" for j, c in self.channel_names]

    @property
    def n_frames(self) -> int:
        return self.values.shape[0]

    def clone(self) -> "BvhData":
        """Deep copy (joints, channel layout, motion values) — the pymo
        ``MocapData.clone`` (``pymo/data.py:26-34``) every transform builds on."""
        joints = {
            name: BvhJoint(j.name, j.parent, j.offset.copy(), list(j.channels),
                           j.order, list(j.children), j.is_end_site)
            for name, j in self.joints.items()
        }
        return BvhData(joints, self.root_name, self.framerate,
                       self.values.copy(), list(self.channel_names))

    def joint_columns(self, joint_names: List[str]) -> List[int]:
        """Column indices for the given joints, in joint-list order
        (JointSelector semantics, ``preprocessing.py:559-599``)."""
        cols = []
        for name in joint_names:
            cols.extend(i for i, (j, _) in enumerate(self.channel_names) if j == name)
        return cols


def parse_bvh(path_or_text: str, is_text: bool = False) -> BvhData:
    if is_text:
        raw = path_or_text.encode()
    else:
        # bytes end to end: a 60 s BEAT recording is ~16 MB of text
        with open(path_or_text, "rb") as f:
            raw = f.read()
    # split off the MOTION block BEFORE tokenizing: a 60 s recording
    # carries ~1.6M float tokens, which go to the native parser in bulk
    # instead of through the header's regex tokenizer
    m_kw = re.search(rb"(?m)^[ \t]*(MOTION)[ \t]*\r?$", raw)
    # standalone-line match first: a joint NAME containing "MOTION" must
    # not truncate the hierarchy; substring fallback keeps accepting
    # nonstandard one-line "MOTION Frames:..." headers.  start(1) skips
    # the line's indentation so the header regex below anchors on the
    # keyword itself.  The fallback only accepts candidates followed by a
    # Frames: header — a bare find() could hit a joint name containing
    # "MOTION" (hierarchy-only template files) and truncate the hierarchy
    if m_kw:
        m_idx = m_kw.start(1)
    else:
        m_idx, search = -1, 0
        while (cand := raw.find(b"MOTION", search)) >= 0:
            # accept Frames: anywhere on the same line (or the immediately
            # following line for "MOTION\nFrames:") — a fixed byte window
            # would reject heavily-padded nonstandard headers
            line_end = raw.find(b"\n", cand)
            next_end = (raw.find(b"\n", line_end + 1)
                        if line_end >= 0 else -1)
            span = raw[cand:(next_end if next_end >= 0 else len(raw))]
            if re.match(rb"MOTION\s+Frames:?", span):
                m_idx = cand
                break
            search = cand + 1
        if m_idx < 0 and re.search(rb"(?m)^[ \t]*MOTION\b", raw):
            # a line-initial MOTION keyword exists but no Frames header
            # follows anywhere: a malformed motion section must raise (as
            # the pre-fallback parser did), not silently degrade to a
            # 0-frame hierarchy-only parse
            raise ValueError("malformed MOTION header")
    tokens = _TOKEN.findall(
        (raw[:m_idx] if m_idx >= 0 else raw).decode())
    pos = 0

    def peek() -> str:
        # a sentinel (never a valid token) instead of IndexError: an empty
        # or hierarchy-truncated file gets a named parse error below
        return tokens[pos] if pos < len(tokens) else "<end of file>"

    def take(expect: Optional[str] = None) -> str:
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError(
                "BVH parse error: unexpected end of file"
                + (f" (expected {expect!r})" if expect is not None else ""))
        tok = tokens[pos]
        if expect is not None and tok != expect:
            raise ValueError(f"BVH parse error: expected {expect!r}, got {tok!r}")
        pos += 1
        return tok

    joints: Dict[str, BvhJoint] = {}
    channel_names: List[Tuple[str, str]] = []

    def parse_joint(parent: Optional[str], kind: str) -> None:
        nonlocal pos
        if kind == "End":
            take("Site")
            name = f"{parent}_Nub"
            is_end = True
        else:
            name = take()
            is_end = False
        take("{")
        take("OFFSET")
        offset = np.array([float(take()) for _ in range(3)])
        channels: List[str] = []
        order = ""
        if not is_end:
            take("CHANNELS")
            n = int(take())
            for _ in range(n):
                ch = take()
                channels.append(ch)
                if ch in ("Xrotation", "Yrotation", "Zrotation"):
                    order += ch[0]
            channel_names.extend((name, c) for c in channels)
        elif peek() == "CHANNELS":
            # The reference's hierarchy template files contain malformed End
            # Sites WITH a CHANNELS line (e.g. hierarchy_upper.txt around
            # LeftHandPinky3_Nub).  Real BVH end sites have no channels and
            # the reference only ever uses these files as raw header text —
            # consume and ignore, registering no columns.
            take("CHANNELS")
            n = int(take())
            for _ in range(n):
                take()
        joints[name] = BvhJoint(name, parent, offset, channels, order,
                                is_end_site=is_end)
        if parent is not None:
            joints[parent].children.append(name)
        while peek() in ("JOINT", "End"):
            kind2 = take()
            parse_joint(name, kind2)
        take("}")

    take("HIERARCHY")
    take("ROOT")
    root_name = peek()  # parse_joint consumes the name itself
    parse_joint(None, "ROOT")

    # MOTION section is optional (hierarchy-template files omit it)
    framerate = 0.0
    values = np.zeros((0, len(channel_names)))
    if m_idx >= 0:
        # ":?\s*" — the old tokenizer dropped colons, accepting "Frames:2"
        # with no space after the colon
        hm = re.match(rb"MOTION\s+Frames:?\s*(\d+)\s+Frame\s+Time:?\s*"
                      rb"([0-9.eE+-]+)", raw[m_idx:m_idx + 256])
        if hm is None:
            raise ValueError("BVH parse error: malformed MOTION header")
        n_frames = int(hm.group(1))
        framerate = float(hm.group(2))
        want = n_frames * len(channel_names)
        flat = parse_floats(raw[m_idx + hm.end():], want)
        if flat.size != want:
            raise ValueError(
                f"BVH motion data truncated: expected {n_frames}x{len(channel_names)}, "
                f"got {flat.size} values")
        values = flat.reshape(n_frames, len(channel_names))

    return BvhData(joints, root_name, framerate, values, channel_names)


def hierarchy_text(data: BvhData) -> str:
    """Regenerate the HIERARCHY section (tab-indented, 6-decimal offsets —
    the layout of the reference's hierarchy template files)."""
    lines: List[str] = ["HIERARCHY"]

    def emit(joint: BvhJoint, depth: int) -> None:
        ind = "\t" * depth
        if joint.is_end_site:
            lines.append(f"{ind}End Site")
        elif joint.parent is None:
            lines.append(f"{ind}ROOT {joint.name}")
        else:
            lines.append(f"{ind}JOINT {joint.name}")
        lines.append(f"{ind}{{")
        off = joint.offset
        lines.append(f"{ind}\tOFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        if not joint.is_end_site:
            lines.append(f"{ind}\tCHANNELS {len(joint.channels)} "
                         + " ".join(joint.channels))
        for child in joint.children:
            emit(data.joints[child], depth + 1)
        lines.append(f"{ind}}}")

    emit(data.joints[data.root_name], 0)
    return "\n".join(lines) + "\n"


def hierarchy_channel_order(data: BvhData) -> List[Tuple[str, str]]:
    """(joint, channel) pairs in hierarchy DFS file order — the column
    order the MOTION block must use."""
    order: List[Tuple[str, str]] = []

    def walk(joint: BvhJoint) -> None:
        if not joint.is_end_site:
            order.extend((joint.name, c) for c in joint.channels)
        for child in joint.children:
            walk(data.joints[child])

    walk(data.joints[data.root_name])
    return order


def ancestor_closure(data: BvhData, names: Sequence[str]) -> Set[str]:
    """The given joints plus every ancestor up to the root."""
    unknown = set(names) - set(data.joints)
    if unknown:
        raise ValueError(
            f"unknown joints (not in this skeleton): {sorted(unknown)}; "
            "check Data.joints / Data.hierarchy_extra_joints")
    keep: Set[str] = set()
    for name in names:
        cur: Optional[str] = name
        while cur is not None:
            if cur in keep:
                break
            keep.add(cur)
            cur = data.joints[cur].parent
    return keep


def prune_hierarchy(data: BvhData, keep: Iterable[str]) -> BvhData:
    """Restrict the skeleton to ``keep`` joints (hierarchy-template maker).

    Reproduces how the reference's shipped ``hierarchy_upper.txt`` relates
    to its full ``hierarchy.txt`` (offset-exact): joints outside ``keep``
    are dropped with their subtrees,
    and a kept joint left with no children gets an End Site carrying the
    OFFSET of its first removed child (the bone tip the viewer still needs
    to draw).  Unlike the reference's hand-trimmed file, the synthesized
    End Sites are well-formed (no stray CHANNELS lines — see the
    parser's bug-compat note above).  The returned BvhData has an empty
    MOTION block; use :func:`hierarchy_text` on it to write a template.
    """
    keep = set(keep)
    if data.root_name not in keep:
        raise ValueError(f"keep set must contain the root {data.root_name!r};"
                         " pass ancestor_closure(data, joints)")
    unknown = keep - set(data.joints)
    if unknown:
        raise ValueError(f"unknown joints in keep set: {sorted(unknown)}")
    joints: Dict[str, BvhJoint] = {}
    channel_names: List[Tuple[str, str]] = []

    def walk(name: str) -> None:
        j = data.joints[name]
        kept_children = [c for c in j.children
                         if c in keep and not data.joints[c].is_end_site]
        new = BvhJoint(j.name, j.parent if j.parent in keep else None,
                       j.offset.copy(), list(j.channels), j.order,
                       children=[], is_end_site=False)
        joints[name] = new
        channel_names.extend((name, c) for c in j.channels)
        if kept_children:
            for c in kept_children:
                new.children.append(c)
                walk(c)
        elif j.children:
            # leaf after pruning: synthesize the End Site from the first
            # dropped child (or reuse the original End Site verbatim)
            tip = data.joints[j.children[0]]
            nub = f"{name}_Nub"
            joints[nub] = BvhJoint(nub, name, tip.offset.copy(), [], "",
                                   children=[], is_end_site=True)
            new.children.append(nub)

    walk(data.root_name)
    values = np.zeros((0, len(channel_names)), dtype=data.values.dtype)
    return BvhData(joints, data.root_name, data.framerate, values,
                   channel_names)


def write_bvh(data: BvhData, path: str, fmt: str = "%.6f") -> None:
    """Columns are looked up BY NAME (reference ``pymo/writers.py:64-67``),
    not positionally: transforms like RootTransformer inverse append
    columns at the end of ``channel_names``, so dumping ``values`` as-is
    would silently write them under the wrong hierarchy channels."""
    header = hierarchy_text(data)
    header += f"MOTION\nFrames: {data.n_frames}\nFrame Time: {data.framerate}\n"
    file_order = hierarchy_channel_order(data)
    if file_order == data.channel_names:
        values = data.values
    else:
        col = {jc: i for i, jc in enumerate(data.channel_names)}
        missing = [jc for jc in file_order if jc not in col]
        if missing:
            raise ValueError(
                f"write_bvh: hierarchy declares channels absent from the "
                f"motion data: {missing[:5]}{'...' if len(missing) > 5 else ''}")
        values = data.values[:, [col[jc] for jc in file_order]]
    np.savetxt(path, values, header=header, comments="", fmt=fmt)
