"""The paper's eleven evaluated models, rebuilt shape-for-shape (§IV).

Graphs carry exact tensor shapes (batch 1, NHWC) and dtype widths; weights
are excluded from the arena exactly as in the paper. Activations are fused
into the producing conv (TFLite convention), so they do not create tensors —
explicit ``elementwise`` ops appear only where a real intermediate exists
(residual adds, pre-activation relus).

Builders: MobileNet v1 (4 variants), MobileNet v2 (2 variants), Inception v4,
Inception-ResNet v2, NasNet Mobile, DenseNet 121, ResNet 50 v2.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core.graph import Graph, Tensor, conv_out_dim


def _make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _name(base: str, dtype_bytes: int) -> str:
    """Graph name with the dtype tag every builder shares (8-bit models are
    the paper's flagship rows and, since the dtype-aware executor layer,
    runnable — the tag keeps reports/benchmarks self-describing)."""
    return base + ("_8bit" if dtype_bytes == 1 else "")


class _B:
    """Builder helper around a Graph, NHWC batch-1."""

    def __init__(self, name: str, dtype_bytes: int = 4):
        self.g = Graph(_name(name, dtype_bytes))
        self.db = dtype_bytes

    def input(self, h: int, w: int, c: int, name: str = "input") -> Tensor:
        return self.g.tensor(name, (h, w, c), self.db, "input")

    def conv(self, x: Tensor, oc: int, k=3, s: int = 1,
             padding: str = "same", name: str = "") -> Tensor:
        kh, kw = (k, k) if isinstance(k, int) else k
        h, w, _ = x.shape
        oh, ow = conv_out_dim(h, kh, s, padding), conv_out_dim(w, kw, s, padding)
        return self.g.op("conv2d", [x], (oh, ow, oc),
                         dict(kernel=(kh, kw), stride=(s, s), padding=padding),
                         name=name)

    def dw(self, x: Tensor, k: int = 3, s: int = 1, padding: str = "same",
           mult: int = 1, name: str = "") -> Tensor:
        h, w, c = x.shape
        oh, ow = conv_out_dim(h, k, s, padding), conv_out_dim(w, k, s, padding)
        return self.g.op("depthwise_conv2d", [x], (oh, ow, c * mult),
                         dict(kernel=(k, k), stride=(s, s), padding=padding,
                              multiplier=mult), name=name)

    def sep(self, x: Tensor, oc: int, k: int = 3, s: int = 1,
            padding: str = "same", name: str = "") -> Tensor:
        return self.conv(self.dw(x, k, s, padding, name=name + "_dw"), oc, 1, 1,
                         "same", name=name + "_pw")

    def pool(self, x: Tensor, k: int, s: int, padding: str = "valid",
             mode: str = "avg", name: str = "") -> Tensor:
        h, w, c = x.shape
        oh, ow = conv_out_dim(h, k, s, padding), conv_out_dim(w, k, s, padding)
        return self.g.op("pool", [x], (oh, ow, c),
                         dict(kernel=(k, k), stride=(s, s), padding=padding,
                              mode=mode), name=name)

    def add(self, a: Tensor, b: Tensor, name: str = "") -> Tensor:
        return self.g.op("elementwise", [a, b], a.shape, dict(fn="add"), name=name)

    def relu(self, x: Tensor, name: str = "") -> Tensor:
        return self.g.op("elementwise", [x], x.shape, dict(fn="relu"), name=name)

    def concat(self, xs: Sequence[Tensor], name: str = "") -> Tensor:
        h, w, _ = xs[0].shape
        c = sum(t.shape[-1] for t in xs)
        return self.g.op("concat", list(xs), (h, w, c), dict(axis=-1), name=name)

    def head(self, x: Tensor, classes: int = 1000) -> Graph:
        h, w, c = x.shape
        x = self.g.op("mean", [x], (c,), dict(axes=(0, 1)), name="gap")
        x = self.g.op("fully_connected", [x], (classes,), name="logits")
        self.g.op("softmax", [x], (classes,), name="prob", out_kind="output")
        self.g.validate()
        return self.g


# ---------------------------------------------------------------------------
# MobileNet v1 / v2
# ---------------------------------------------------------------------------


def mobilenet_v1(alpha: float = 1.0, res: int = 224, dtype_bytes: int = 4,
                 external_input: bool = False) -> Graph:
    """``external_input``: model input lives outside the arena (e.g. a
    camera DMA buffer) — the convention of the paper's §II.A example."""
    b = _B(f"mobilenet_v1_{alpha}_{res}", dtype_bytes)
    c = lambda ch: max(8, int(ch * alpha))
    x = b.input(res, res, 3)
    if external_input:
        x.kind = "weight"
    x = b.conv(x, c(32), 3, 2, name="conv1")
    plan = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
            (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024)]
    for i, (s, ch) in enumerate(plan):
        x = b.dw(x, 3, s, name=f"dw{i + 1}")
        x = b.conv(x, c(ch), 1, 1, name=f"pw{i + 1}")
    return b.head(x)


def mobilenet_v2(alpha: float = 1.0, res: int = 224, dtype_bytes: int = 4) -> Graph:
    b = _B(f"mobilenet_v2_{alpha}_{res}", dtype_bytes)
    x = b.input(res, res, 3)
    first = _make_divisible(32 * alpha)
    x = b.conv(x, first, 3, 2, name="conv1")
    # (expansion t, channels c, repeats n, first stride s)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    blk = 0
    for t, ch, n, s0 in cfg:
        oc = _make_divisible(ch * alpha)
        for i in range(n):
            s = s0 if i == 0 else 1
            inp = x
            ic = x.shape[-1]
            h = x
            if t != 1:
                h = b.conv(h, ic * t, 1, 1, name=f"b{blk}_expand")
            h = b.dw(h, 3, s, name=f"b{blk}_dw")
            h = b.conv(h, oc, 1, 1, name=f"b{blk}_project")
            if s == 1 and ic == oc:
                h = b.add(h, inp, name=f"b{blk}_add")
            x = h
            blk += 1
    last = _make_divisible(1280 * alpha) if alpha > 1.0 else 1280
    x = b.conv(x, last, 1, 1, name="conv_last")
    return b.head(x)


# ---------------------------------------------------------------------------
# ResNet 50 v2 (pre-activation)
# ---------------------------------------------------------------------------


def resnet50_v2(res: int = 224, dtype_bytes: int = 4) -> Graph:
    b = _B("resnet50_v2", dtype_bytes)
    x = b.input(res, res, 3)
    x = b.conv(x, 64, 7, 2, name="conv1")
    x = b.pool(x, 3, 2, "same", "max", name="pool1")
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    bi = 0
    for width, blocks, stride0 in stages:
        for i in range(blocks):
            s = stride0 if i == 0 else 1
            pre = b.relu(x, name=f"r{bi}_preact")           # BN folded, relu real
            if i == 0:
                shortcut = b.conv(pre, width * 4, 1, s, name=f"r{bi}_short")
            else:
                shortcut = x
            h = b.conv(pre, width, 1, s, name=f"r{bi}_c1")
            h = b.conv(h, width, 3, 1, name=f"r{bi}_c2")
            h = b.conv(h, width * 4, 1, 1, name=f"r{bi}_c3")
            x = b.add(h, shortcut, name=f"r{bi}_add")
            bi += 1
    x = b.relu(x, name="postact")
    return b.head(x)


# ---------------------------------------------------------------------------
# DenseNet 121
# ---------------------------------------------------------------------------


def densenet121(res: int = 224, dtype_bytes: int = 4, growth: int = 32) -> Graph:
    b = _B("densenet121", dtype_bytes)
    x = b.input(res, res, 3)
    x = b.conv(x, 64, 7, 2, name="conv1")
    x = b.pool(x, 3, 2, "same", "max", name="pool1")
    li = 0
    for bi, layers in enumerate([6, 12, 24, 16]):
        for _ in range(layers):
            h = b.relu(x, name=f"d{li}_preact")
            h = b.conv(h, 4 * growth, 1, 1, name=f"d{li}_c1")
            h = b.conv(h, growth, 3, 1, name=f"d{li}_c2")
            x = b.concat([x, h], name=f"d{li}_cat")
            li += 1
        if bi < 3:  # transition
            h = b.relu(x, name=f"t{bi}_preact")
            h = b.conv(h, x.shape[-1] // 2, 1, 1, name=f"t{bi}_c")
            x = b.pool(h, 2, 2, "valid", "avg", name=f"t{bi}_pool")
    x = b.relu(x, name="postact")
    return b.head(x)


# ---------------------------------------------------------------------------
# Inception v4 & Inception-ResNet v2 (Szegedy et al., 2017)
# ---------------------------------------------------------------------------


def _inception_stem(b: _B, x: Tensor) -> Tensor:
    x = b.conv(x, 32, 3, 2, "valid", name="stem_c1")          # 149
    x = b.conv(x, 32, 3, 1, "valid", name="stem_c2")          # 147
    x = b.conv(x, 64, 3, 1, "same", name="stem_c3")           # 147
    p = b.pool(x, 3, 2, "valid", "max", name="stem_p1")       # 73
    c = b.conv(x, 96, 3, 2, "valid", name="stem_c4")          # 73
    x = b.concat([p, c], name="stem_cat1")                     # 73x160
    a = b.conv(x, 64, 1, 1, name="stem_a1")
    a = b.conv(a, 96, 3, 1, "valid", name="stem_a2")          # 71
    d = b.conv(x, 64, 1, 1, name="stem_b1")
    d = b.conv(d, 64, (1, 7), 1, "same", name="stem_b2")
    d = b.conv(d, 64, (7, 1), 1, "same", name="stem_b3")
    d = b.conv(d, 96, 3, 1, "valid", name="stem_b4")          # 71
    x = b.concat([a, d], name="stem_cat2")                     # 71x192
    p = b.pool(x, 3, 2, "valid", "max", name="stem_p2")       # 35
    c = b.conv(x, 192, 3, 2, "valid", name="stem_c5")         # 35
    return b.concat([p, c], name="stem_cat3")                  # 35x384


def inception_v4(res: int = 299, dtype_bytes: int = 4) -> Graph:
    b = _B("inception_v4", dtype_bytes)
    x = b.input(res, res, 3)
    x = _inception_stem(b, x)

    def block_a(x, i):
        b1 = b.conv(x, 96, 1, 1, name=f"a{i}_b1")
        b2 = b.conv(b.conv(x, 64, 1, 1, name=f"a{i}_b2a"), 96, 3, 1, name=f"a{i}_b2b")
        b3 = b.conv(b.conv(b.conv(x, 64, 1, 1, name=f"a{i}_b3a"), 96, 3, 1,
                           name=f"a{i}_b3b"), 96, 3, 1, name=f"a{i}_b3c")
        b4 = b.conv(b.pool(x, 3, 1, "same", "avg", name=f"a{i}_p"), 96, 1, 1,
                    name=f"a{i}_b4")
        return b.concat([b1, b2, b3, b4], name=f"a{i}_cat")

    for i in range(4):
        x = block_a(x, i)
    # reduction A
    r1 = b.conv(x, 384, 3, 2, "valid", name="ra_1")
    r2 = b.conv(b.conv(b.conv(x, 192, 1, 1, name="ra_2a"), 224, 3, 1,
                       name="ra_2b"), 256, 3, 2, "valid", name="ra_2c")
    r3 = b.pool(x, 3, 2, "valid", "max", name="ra_p")
    x = b.concat([r1, r2, r3], name="ra_cat")                  # 17x1024

    def block_b(x, i):
        b1 = b.conv(x, 384, 1, 1, name=f"ib{i}_b1")
        b2 = b.conv(x, 192, 1, 1, name=f"ib{i}_b2a")
        b2 = b.conv(b2, 224, (1, 7), 1, name=f"ib{i}_b2b")
        b2 = b.conv(b2, 256, (7, 1), 1, name=f"ib{i}_b2c")
        b3 = b.conv(x, 192, 1, 1, name=f"ib{i}_b3a")
        b3 = b.conv(b3, 192, (7, 1), 1, name=f"ib{i}_b3b")
        b3 = b.conv(b3, 224, (1, 7), 1, name=f"ib{i}_b3c")
        b3 = b.conv(b3, 224, (7, 1), 1, name=f"ib{i}_b3d")
        b3 = b.conv(b3, 256, (1, 7), 1, name=f"ib{i}_b3e")
        b4 = b.conv(b.pool(x, 3, 1, "same", "avg", name=f"ib{i}_p"), 128, 1, 1,
                    name=f"ib{i}_b4")
        return b.concat([b1, b2, b3, b4], name=f"ib{i}_cat")

    for i in range(7):
        x = block_b(x, i)
    # reduction B
    r1 = b.conv(b.conv(x, 192, 1, 1, name="rb_1a"), 192, 3, 2, "valid", name="rb_1b")
    r2 = b.conv(x, 256, 1, 1, name="rb_2a")
    r2 = b.conv(r2, 256, (1, 7), 1, name="rb_2b")
    r2 = b.conv(r2, 320, (7, 1), 1, name="rb_2c")
    r2 = b.conv(r2, 320, 3, 2, "valid", name="rb_2d")
    r3 = b.pool(x, 3, 2, "valid", "max", name="rb_p")
    x = b.concat([r1, r2, r3], name="rb_cat")                  # 8x1536

    def block_c(x, i):
        b1 = b.conv(x, 256, 1, 1, name=f"c{i}_b1")
        h = b.conv(x, 384, 1, 1, name=f"c{i}_b2a")
        b2 = b.concat([b.conv(h, 256, 3, 1, name=f"c{i}_b2b"),
                       b.conv(h, 256, 3, 1, name=f"c{i}_b2c")], name=f"c{i}_cat2")
        h = b.conv(b.conv(x, 384, 1, 1, name=f"c{i}_b3a"), 448, 3, 1, name=f"c{i}_b3b")
        h = b.conv(h, 512, 3, 1, name=f"c{i}_b3c")
        b3 = b.concat([b.conv(h, 256, 3, 1, name=f"c{i}_b3d"),
                       b.conv(h, 256, 3, 1, name=f"c{i}_b3e")], name=f"c{i}_cat3")
        b4 = b.conv(b.pool(x, 3, 1, "same", "avg", name=f"c{i}_p"), 256, 1, 1,
                    name=f"c{i}_b4")
        return b.concat([b1, b2, b3, b4], name=f"c{i}_cat")

    for i in range(3):
        x = block_c(x, i)
    return b.head(x)


def inception_resnet_v2(res: int = 299, dtype_bytes: int = 4) -> Graph:
    # Keras Applications variant: *sequential* stem (conv/conv/conv/pool/
    # conv/conv/pool), which is where the paper's 34.4 % saving lives.
    b = _B("inception_resnet_v2", dtype_bytes)
    x = b.input(res, res, 3)
    x = b.conv(x, 32, 3, 2, "valid", name="stem_c1")          # 149
    x = b.conv(x, 32, 3, 1, "valid", name="stem_c2")          # 147
    x = b.conv(x, 64, 3, 1, "same", name="stem_c3")           # 147  (2x input)
    x = b.pool(x, 3, 2, "valid", "max", name="stem_p1")       # 73
    x = b.conv(x, 80, 1, 1, name="stem_c4")
    x = b.conv(x, 192, 3, 1, "valid", name="stem_c5")         # 71
    x = b.pool(x, 3, 2, "valid", "max", name="stem_p2")       # 35x192
    # mixed_5b (Inception-A): -> 35x320
    b1 = b.conv(x, 96, 1, 1, name="m5b_b1")
    b2 = b.conv(b.conv(x, 48, 1, 1, name="m5b_b2a"), 64, 5, 1, name="m5b_b2b")
    b3 = b.conv(b.conv(b.conv(x, 64, 1, 1, name="m5b_b3a"), 96, 3, 1,
                       name="m5b_b3b"), 96, 3, 1, name="m5b_b3c")
    b4 = b.conv(b.pool(x, 3, 1, "same", "avg", name="m5b_p"), 64, 1, 1,
                name="m5b_b4")
    x = b.concat([b1, b2, b3, b4], name="m5b_cat")             # 35x320

    def block35(x, i):  # Inception-ResNet-A
        b1 = b.conv(x, 32, 1, 1, name=f"m35_{i}_b1")
        b2 = b.conv(b.conv(x, 32, 1, 1, name=f"m35_{i}_b2a"), 32, 3, 1,
                    name=f"m35_{i}_b2b")
        b3 = b.conv(b.conv(b.conv(x, 32, 1, 1, name=f"m35_{i}_b3a"), 48, 3, 1,
                           name=f"m35_{i}_b3b"), 64, 3, 1, name=f"m35_{i}_b3c")
        up = b.conv(b.concat([b1, b2, b3], name=f"m35_{i}_cat"), x.shape[-1],
                    1, 1, name=f"m35_{i}_up")
        return b.add(x, up, name=f"m35_{i}_add")

    for i in range(10):
        x = block35(x, i)
    r1 = b.conv(x, 384, 3, 2, "valid", name="ra_1")
    r2 = b.conv(b.conv(b.conv(x, 256, 1, 1, name="ra_2a"), 256, 3, 1,
                       name="ra_2b"), 384, 3, 2, "valid", name="ra_2c")
    r3 = b.pool(x, 3, 2, "valid", "max", name="ra_p")
    x = b.concat([r1, r2, r3], name="ra_cat")                  # 17x1152

    def block17(x, i):
        b1 = b.conv(x, 192, 1, 1, name=f"m17_{i}_b1")
        b2 = b.conv(x, 128, 1, 1, name=f"m17_{i}_b2a")
        b2 = b.conv(b2, 160, (1, 7), 1, name=f"m17_{i}_b2b")
        b2 = b.conv(b2, 192, (7, 1), 1, name=f"m17_{i}_b2c")
        up = b.conv(b.concat([b1, b2], name=f"m17_{i}_cat"), x.shape[-1], 1, 1,
                    name=f"m17_{i}_up")
        return b.add(x, up, name=f"m17_{i}_add")

    for i in range(20):
        x = block17(x, i)
    r1 = b.conv(b.conv(x, 256, 1, 1, name="rb_1a"), 384, 3, 2, "valid", name="rb_1b")
    r2 = b.conv(b.conv(x, 256, 1, 1, name="rb_2a"), 288, 3, 2, "valid", name="rb_2b")
    r3 = b.conv(b.conv(b.conv(x, 256, 1, 1, name="rb_3a"), 288, 3, 1,
                       name="rb_3b"), 320, 3, 2, "valid", name="rb_3c")
    r4 = b.pool(x, 3, 2, "valid", "max", name="rb_p")
    x = b.concat([r1, r2, r3, r4], name="rb_cat")              # 8x2144

    def block8(x, i):
        b1 = b.conv(x, 192, 1, 1, name=f"m8_{i}_b1")
        b2 = b.conv(x, 192, 1, 1, name=f"m8_{i}_b2a")
        b2 = b.conv(b2, 224, (1, 3), 1, name=f"m8_{i}_b2b")
        b2 = b.conv(b2, 256, (3, 1), 1, name=f"m8_{i}_b2c")
        up = b.conv(b.concat([b1, b2], name=f"m8_{i}_cat"), x.shape[-1], 1, 1,
                    name=f"m8_{i}_up")
        return b.add(x, up, name=f"m8_{i}_add")

    for i in range(10):
        x = block8(x, i)
    x = b.conv(x, 1536, 1, 1, name="conv_final")
    return b.head(x)


# ---------------------------------------------------------------------------
# NasNet Mobile (NasNet-A 4 @ 1056) — faithful cell topology, separable convs
# ---------------------------------------------------------------------------


def nasnet_mobile(res: int = 224, dtype_bytes: int = 4) -> Graph:
    b = _B("nasnet_mobile", dtype_bytes)
    penultimate = 44  # filters: 44 * 24 = 1056 at the last cell

    def fit(x: Tensor, h: int, w: int, c: int, name: str) -> Tensor:
        """1x1 conv (with stride if spatial mismatch) to align shapes."""
        s = x.shape[-3] // h
        return b.conv(x, c, 1, max(1, s), name=name)

    def normal_cell(prev: Tensor, cur: Tensor, filters: int, name: str) -> Tensor:
        p = fit(prev, cur.shape[-3], cur.shape[-2], filters, f"{name}_fitp")
        h = b.conv(cur, filters, 1, 1, name=f"{name}_fith")
        y1 = b.add(b.sep(h, filters, 5, 1, name=f"{name}_s1"),
                   b.sep(p, filters, 3, 1, name=f"{name}_s2"), name=f"{name}_a1")
        y2 = b.add(b.sep(p, filters, 5, 1, name=f"{name}_s3"),
                   b.sep(p, filters, 3, 1, name=f"{name}_s4"), name=f"{name}_a2")
        y3 = b.add(b.pool(h, 3, 1, "same", "avg", name=f"{name}_p1"), p,
                   name=f"{name}_a3")
        y4 = b.add(b.pool(p, 3, 1, "same", "avg", name=f"{name}_p2"),
                   b.pool(p, 3, 1, "same", "avg", name=f"{name}_p3"),
                   name=f"{name}_a4")
        y5 = b.add(b.sep(h, filters, 3, 1, name=f"{name}_s5"), h, name=f"{name}_a5")
        return b.concat([p, y1, y2, y3, y4, y5], name=f"{name}_cat")

    def reduction_cell(prev: Tensor, cur: Tensor, filters: int, name: str) -> Tensor:
        p = fit(prev, cur.shape[-3], cur.shape[-2], filters, f"{name}_fitp")
        h = b.conv(cur, filters, 1, 1, name=f"{name}_fith")
        z1 = b.add(b.sep(h, filters, 5, 2, name=f"{name}_s1"),
                   b.sep(p, filters, 7, 2, name=f"{name}_s2"), name=f"{name}_a1")
        z2 = b.add(b.pool(h, 3, 2, "same", "max", name=f"{name}_p1"),
                   b.sep(p, filters, 7, 2, name=f"{name}_s3"), name=f"{name}_a2")
        z3 = b.add(b.pool(h, 3, 2, "same", "avg", name=f"{name}_p2"),
                   b.sep(p, filters, 5, 2, name=f"{name}_s4"), name=f"{name}_a3")
        z4 = b.add(b.pool(z1, 3, 1, "same", "max", name=f"{name}_p3"),
                   b.sep(z1, filters, 3, 1, name=f"{name}_s5"), name=f"{name}_a4")
        z5 = b.add(b.pool(h, 3, 2, "same", "avg", name=f"{name}_p4"),
                   z1, name=f"{name}_a5")
        return b.concat([z2, z3, z4, z5], name=f"{name}_cat")

    x = b.input(res, res, 3)
    x = b.conv(x, 32, 3, 2, "valid", name="stem_conv")        # 111
    prev, cur = x, x
    cur = reduction_cell(prev, cur, penultimate // 4, "stem_r1")
    prev, cur = x, cur
    nxt = reduction_cell(prev, cur, penultimate // 2, "stem_r2")
    prev, cur = cur, nxt
    f = penultimate
    for stage in range(3):
        for i in range(4):
            nxt = normal_cell(prev, cur, f, f"n{stage}_{i}")
            prev, cur = cur, nxt
        if stage < 2:
            f *= 2
            nxt = reduction_cell(prev, cur, f, f"red{stage}")
            prev, cur = cur, nxt
    cur = b.relu(cur, name="postact")
    return b.head(cur)


# ---------------------------------------------------------------------------
# SqueezeNet 1.1 — the paper's §II.C example (concat-dominated peak)
# ---------------------------------------------------------------------------


def squeezenet(res: int = 224, dtype_bytes: int = 4) -> Graph:
    b = _B("squeezenet", dtype_bytes)

    def fire(x, squeeze, expand, name):
        s = b.conv(x, squeeze, 1, 1, name=f"{name}_sq")
        e1 = b.conv(s, expand, 1, 1, name=f"{name}_e1")
        e3 = b.conv(s, expand, 3, 1, name=f"{name}_e3")
        return b.concat([e1, e3], name=f"{name}_cat")

    x = b.input(res, res, 3)
    x = b.conv(x, 64, 3, 2, "valid", name="conv1")            # 111
    x = b.pool(x, 3, 2, "valid", "max", name="pool1")         # 55
    x = fire(x, 16, 64, "fire2")
    x = fire(x, 16, 64, "fire3")
    x = b.pool(x, 3, 2, "valid", "max", name="pool3")         # 27
    x = fire(x, 32, 128, "fire4")
    x = fire(x, 32, 128, "fire5")
    x = b.pool(x, 3, 2, "valid", "max", name="pool5")         # 13
    x = fire(x, 48, 192, "fire6")
    x = fire(x, 48, 192, "fire7")
    x = fire(x, 64, 256, "fire8")
    x = fire(x, 64, 256, "fire9")
    x = b.conv(x, 1000, 1, 1, name="conv10")
    return b.head(x)


# ---------------------------------------------------------------------------
# Registry: the 11 rows of Table III
# ---------------------------------------------------------------------------

TABLE3_MODELS = {
    "mobilenet_v1_1.0_224": (lambda: mobilenet_v1(1.0, 224, 4), 4704, 3136),
    "mobilenet_v1_1.0_224_8bit": (lambda: mobilenet_v1(1.0, 224, 1), 1176, 784),
    "mobilenet_v1_0.25_224": (lambda: mobilenet_v1(0.25, 224, 4), 1176, 786),
    "mobilenet_v1_0.25_128_8bit": (lambda: mobilenet_v1(0.25, 128, 1), 96, 64),
    "mobilenet_v2_0.35_224": (lambda: mobilenet_v2(0.35, 224, 4), 2940, 2352),
    "mobilenet_v2_1.0_224": (lambda: mobilenet_v2(1.0, 224, 4), 5880, 4704),
    "inception_v4": (lambda: inception_v4(299, 4), 10879, 10079),
    "inception_resnet_v2": (lambda: inception_resnet_v2(299, 4), 8399, 5504),
    "nasnet_mobile": (lambda: nasnet_mobile(224, 4), 4540, 4540),
    "densenet_121": (lambda: densenet121(224, 4), 8624, 8232),
    "resnet_50_v2": (lambda: resnet50_v2(224, 4), 10976, 10976),
}

#: The paper's flagship 8-bit rows (Table III measures its headline savings
#: on these). Since the dtype-aware executor layer they are *executable*,
#: not just plannable — table3_memory_savings executes and parity-checks
#: them against the quantised reference.
TABLE3_8BIT_MODELS = ("mobilenet_v1_1.0_224_8bit",
                      "mobilenet_v1_0.25_128_8bit")


def executable_models() -> dict:
    """The Table III rows whose (untransformed) graphs the arena executor
    backends accept — i.e. the rows that can be run, not only planned."""
    from repro_torch.core import exec as X
    return {name: spec for name, spec in TABLE3_MODELS.items()
            if X.executable(spec[0]())}
