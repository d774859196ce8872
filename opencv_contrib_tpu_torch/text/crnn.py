"""CRNN-class holistic text recognizer with CTC training, the port of
opencv_contrib_tpu/text/crnn.py.

Reference anchor: text/src/ocr_holistic.cpp (OCRHolisticWordRecognizer —
a word-spotting CNN) and the TextRecognitionModel-era CRNN heads the text
module delegates to cv::dnn for. The reference loads pretrained Caffe
models; here the model TRAINS IN-REPO on synthetic text rendered from the
built-in glyph bank (`text.ocr.render_text`), from the twin's numpy draws.

The bidirectional GRU is flax's cell written out (`models.layers.GRUCell`).
Its backward pass keeps the twin's order: flax's `nn.RNN(reverse=True)`
with `keep_order=False` returns at column t the state after reading
columns W-1 ... W-1-t, and the twin concatenates that with the forward
state of column t; here the same (a forward run over the flipped columns,
not flipped back). The CTC loss is optax's log-space forward recursion over
T (`ctc_loss`), differentiated by autograd as optax is by JAX, so it is
deterministic on the card (torch's CUDA ctc_loss backward sums with
atomics). Blank id 0; decoding is greedy collapse.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from opencv_contrib_tpu_torch.models.layers import Conv, Dense, GRUCell, check_state, reset_flax
from opencv_contrib_tpu_torch.text.ocr import VOCAB, render_text
from opencv_contrib_tpu_torch.utils.device import constant, resolve
from opencv_contrib_tpu_torch.utils.optim import Adam, deterministic
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

N_CLASSES = len(VOCAB) + 1  # + blank at id 0
LOG_EPSILON = -1e5  # optax's log(+0)


class CRNN(nn.Module):
    """Small conv + bidirectional GRU + per-column logits: (B, H, W, 1) ->
    (B, W', N_CLASSES), W' = ceil(W / 2). `height` fixes the Dense input
    (flax infers it from the first input)."""

    def __init__(self, features: int = 48, height: int = 20):
        super().__init__()
        self.features = features
        self.Conv_0 = Conv(1, 16, 3, stride=(2, 1))
        self.Conv_1 = Conv(16, 32, 3, stride=(2, 2))
        h = -(-(-(-height // 2)) // 2)
        self.Dense_0 = Dense(h * 32, features)
        self.GRUCell_0 = GRUCell(features, features)
        self.GRUCell_1 = GRUCell(features, features)
        self.Dense_1 = Dense(2 * features, N_CLASSES)

    def forward(self, x):
        x = torch.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        x = torch.relu(self.Conv_1(x))
        B, C, H, W = x.shape
        cols = self.Dense_0(x.permute(0, 3, 2, 1).reshape(B, W, H * C))  # (H, C) flattened, C fastest
        fwd = self.GRUCell_0.run(cols)
        bwd = self.GRUCell_1.run(torch.flip(cols, (1,)))  # reversed order kept (flax's keep_order=False)
        return self.Dense_1(torch.cat([fwd, bwd], -1))


def encode_label(s: str, max_len: int):
    ids = [VOCAB.index(c) + 1 for c in s.upper() if c in VOCAB]
    pad = max_len - len(ids)
    return np.array(ids + [0] * pad, np.int32), np.array([0.0] * len(ids) + [1.0] * pad, np.float32)


def make_batch(words, H: int, W: int, max_len: int, rng, noise: float = 0.05):
    """Rendered words (B, H, W, 1), labels (B, max_len) int32 and their
    paddings (B, max_len), host tensors (the twin's draws from `rng`)."""
    imgs = np.zeros((len(words), H, W, 1), np.float32)
    labels = np.zeros((len(words), max_len), np.int32)
    lpad = np.ones((len(words), max_len), np.float32)
    for i, w in enumerate(words):
        img = render_text(w, scale=2, noise=noise, rng=rng)
        h, ww = img.shape
        imgs[i, :min(h, H), :min(ww, W), 0] = img[:H, :W]
        labels[i], lpad[i] = encode_label(w, max_len)
    return torch.from_numpy(imgs), torch.from_numpy(labels), torch.from_numpy(lpad)


def ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id: int = 0):
    """optax.ctc_loss: per-sequence negative log-likelihoods (B,) of
    `labels` (B, N) under `logits` (B, T, K), by optax's recursion over T of
    the blank and label forward variables in log space."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, -1)
    labellens = N - label_paddings.sum(1).to(torch.int64)
    labels = labels.long()
    repeat = torch.cat([(labels[:, :-1] == labels[:, 1:]).to(logits.dtype), logits.new_zeros((B, 1))], 1)
    logprobs_phi = logprobs[:, :, blank_id]  # (B, T)
    logprobs_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(B, T, N))  # (B, T, N)
    phi = torch.full((B, N + 1), LOG_EPSILON, dtype=logits.dtype, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    emit = torch.full((B, N), LOG_EPSILON, dtype=logits.dtype, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], 1)

    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + LOG_EPSILON * repeat)
        lp_emit, lp_phi = logprobs_emit[:, t], logprobs_phi[:, t:t + 1]
        pad = logit_paddings[:, t:t + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + LOG_EPSILON * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


def _loss(model, imgs, labels, lpad):
    logits = model(imgs)
    logit_pad = logits.new_zeros(logits.shape[:2])
    return ctc_loss(logits, logit_pad, labels, lpad).mean()


def _graphed_loss_grad(model: CRNN, imgs, labels, lpad):
    """One forward and backward of the CTC loss captured as a CUDA graph on
    the card: the step's ~2,500 small launches (two 20-step GRUs, the
    recursion over T, their gradients) replay from one call, where each
    eager launch costs the host ~15 us. The parameters' gradients are the
    graph's own tensors, written (not accumulated) by each replay. Returns
    step(batch): the batch copied into the graph's inputs, then a replay."""
    static = [imgs.clone(), labels.clone(), lpad.clone()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator and cuDNN off the graph; the parameters do not move
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            _loss(model, *static).backward()
    torch.cuda.current_stream().wait_stream(side)
    model.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _loss(model, *static).backward()

    def step(batch):
        for s, b in zip(static, batch):
            s.copy_(b)
        graph.replay()

    return step


def train_crnn(words, n_steps: int = 300, H: int = 20, W: int = 96, max_len: int = 8, lr: float = 3e-3,
               seed: int = 0, features: int = 48, params=None, device="cuda"):
    """Train on synthetic renders of `words` (the twin's numpy draws of
    `seed`, in its order) on `device`; returns (model, params), params the
    model's parameter dict (`recognize` applies it). `params` given (a
    state dict, e.g. `interop.crnn_params` of the twin's init) sets the
    start, else flax's initialisers draw it from a generator of `seed`. On
    the card each step's loss and gradient is one replay of a CUDA graph
    (`_graphed_loss_grad`), the same kernels as the eager step."""
    dev = resolve(device)
    model = CRNN(features=features, height=H)
    rng = np.random.default_rng(seed)
    imgs, labels, lpad = make_batch(words, H, W, max_len, rng)  # the twin's init batch, drawn first
    if params is None:
        reset_flax(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(check_state(model, params, "CRNN"))
    model.to(dev)
    opt = Adam(model.parameters(), lr)
    graphed = None
    with f32_matmul_precision(), deterministic():
        for _ in range(n_steps):
            if len(words) <= 16:
                # full-batch: deterministic, convergence independent of sampling
                batch = make_batch(words, H, W, max_len, rng)
            else:
                batch = make_batch([words[i] for i in rng.integers(0, len(words), 16)], H, W, max_len, rng)
            batch = tuple(constant(b.numpy(), dev, b.dtype) for b in batch)
            if dev.type == "cuda":
                if graphed is None:
                    graphed = _graphed_loss_grad(model, *batch)
                graphed(batch)
            else:
                opt.zero_grad()
                _loss(model, *batch).backward()
            opt.step()
    return model, dict(model.named_parameters())


def ctc_greedy_decode(logits) -> list[str]:
    """Greedy CTC decode of (B, T, C) logits -> strings (one read of the
    device)."""
    ids = torch.argmax(torch.as_tensor(logits), -1).cpu().numpy()
    out = []
    for row in ids:
        s = []
        prev = -1
        for t in row:
            if t != prev and t != 0:
                s.append(VOCAB[t - 1])
            prev = t
        out.append("".join(s))
    return out


def recognize(model: CRNN, params, imgs) -> list[str]:
    """(B, H, W, 1) -> decoded strings (OCRHolisticWordRecognizer::run), the
    model applied with `params` (its parameter dict, or None for its own)
    on the model's device."""
    dev = next(model.parameters()).device
    x = imgs.to(dev, torch.float32) if isinstance(imgs, torch.Tensor) else constant(np.asarray(imgs, np.float32), dev)
    with torch.no_grad(), f32_matmul_precision():
        logits = model(x) if params is None else torch.func.functional_call(model, params, (x,))
    return ctc_greedy_decode(logits)
