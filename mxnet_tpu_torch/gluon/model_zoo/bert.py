"""BERT (counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``; ref:
GluonNLP bert.py — BERTEncoder/BERTModel). Attention uses the
reference's interleaved packed-QKV layout (src/operator/contrib/
transformer.cc), sequence dimension first (TNC).

On the card, one encoder layer runs four hand-written forward kernels —
the fused self-attention, the bias+GeLU and bias+residual Dense
epilogues and the LayerNorm — and in training the dropout kernel and
the backward kernels of attention, bias+GeLU and LayerNorm
(ops/cuda_*.py). ``BERTMLMLoss`` is the masked-LM head with its cross
entropy: by default the chunked LM-head cross entropy, as in the
reference.
"""
from __future__ import annotations

from ...config import get as _cfg
from ..block import HybridBlock
from .. import nn

__all__ = ["BERTEncoder", "BERTModel", "BERTMLMLoss", "bert_12_768_12",
           "bert_24_1024_16",
           "PositionwiseFFN", "BERTEncoderCell"]


class PositionwiseFFN(HybridBlock):
    """Dense→GeLU→Dense FFN with fused epilogues: ffn_1
    carries the bias+GeLU epilogue; when there is no dropout between
    ffn_2 and the residual add, ffn_2 carries the bias+residual
    epilogue too (dropout must see the biased activations, so with
    dropout>0 the residual add stays outside). Parameter names/shapes
    are the reference's, so weights carry over by name."""

    def __init__(self, units, hidden_size, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._dropout = dropout
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                                  epilogue="gelu", prefix="ffn_1_")
            self.ffn_2 = nn.Dense(units, flatten=False,
                                  epilogue=None if dropout
                                  else "residual", prefix="ffn_2_")
            self.dropout_layer = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x):
        out = self.ffn_1(x)              # fused bias+GeLU epilogue
        if self._dropout:
            out = self.ffn_2(out)
            out = self.dropout_layer(out)
            return self.layer_norm(out + x)
        return self.layer_norm(self.ffn_2(out, x))


class BERTEncoderCell(HybridBlock):
    """One transformer layer, interleaved self-attention."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        with self.name_scope():
            self.attn_qkv = nn.Dense(units * 3, flatten=False,
                                     prefix="attn_qkv_")
            self.proj = nn.Dense(units, flatten=False,
                                 epilogue="residual", prefix="proj_")
            self.attn_dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(in_channels=units)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout)

    def hybrid_forward(self, F, x, mask=None):
        # x: (seq, batch, units)
        qkv = self.attn_qkv(x)
        if mask is None:
            # fused attention path (scores/softmax/context in one
            # kernel; ops/contrib_ops.py _contrib_sdp_selfatt)
            context = F._contrib_sdp_selfatt(
                qkv, heads=self._num_heads, dropout=self._dropout)
        else:
            scores = F._contrib_interleaved_matmul_selfatt_qk(
                qkv, heads=self._num_heads)
            scores = scores + mask
            att = F.softmax(scores, axis=-1)
            att = self.attn_dropout(att)
            context = F._contrib_interleaved_matmul_selfatt_valatt(
                qkv, att, heads=self._num_heads)
        # fused bias+residual epilogue (ops/cuda_epilogue.py)
        out = self.proj(context, x)
        out = self.layer_norm(out)
        return self.ffn(out)


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, max_length=512, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init=None)
            self.dropout_layer = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(in_channels=units)
            self.transformer_cells = nn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.transformer_cells.add(BERTEncoderCell(
                    units, hidden_size, num_heads, dropout,
                    prefix="transformer%d_" % i))

    def hybrid_forward(self, F, x, mask=None, position_weight=None):
        # x: (seq, batch, units); add learned positions
        steps = F.slice_like(position_weight, x, axes=(0,))
        out = x + F.expand_dims(steps, axis=1)
        out = self.layer_norm(out)
        out = self.dropout_layer(out)
        for cell in self.transformer_cells:
            out = cell(out) if mask is None else cell(out, mask)
        return out


class BERTModel(HybridBlock):
    """Embeddings + encoder + MLM/NSP heads (ref: GluonNLP BERTModel)."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, max_length=512, vocab_size=30522,
                 token_type_vocab_size=2, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embed_")
            self.token_type_embed = nn.Embedding(token_type_vocab_size, units,
                                                 prefix="token_type_embed_")
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, max_length, dropout,
                                       prefix="encoder_")
            self.use_pooler = use_pooler
            self.use_decoder = use_decoder
            self.use_classifier = use_classifier
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       prefix="pooler_")
            if use_classifier:
                self.classifier = nn.Dense(2, prefix="classifier_")
            if use_decoder:
                self.decoder = nn.HybridSequential(prefix="decoder_")
                with self.decoder.name_scope():
                    self.decoder.add(nn.Dense(units, flatten=False,
                                              activation=None))
                    self.decoder.add(nn.LayerNorm(in_channels=units))
                    self.decoder.add(nn.Dense(vocab_size, flatten=False))

    def hybrid_forward(self, F, inputs, token_types):
        # inputs/token_types: (batch, seq) int ids
        emb = self.word_embed(inputs) + self.token_type_embed(token_types)
        emb = F.transpose(emb, axes=(1, 0, 2))  # -> (seq, batch, units)
        seq_out = self.encoder(emb)
        outputs = [F.transpose(seq_out, axes=(1, 0, 2))]
        if self.use_pooler:
            cls = F.slice_axis(seq_out, axis=0, begin=0, end=1)
            pooled = self.pooler(F.Reshape(cls, shape=(-3, -2)))
            outputs.append(pooled)
            if self.use_classifier:
                outputs.append(self.classifier(pooled))
        if self.use_decoder:
            outputs.append(self.decoder(seq_out))
        return tuple(outputs)


class BERTMLMLoss(HybridBlock):
    """Parametric MLM head + cross entropy as one block (ref: bert.py ::
    BERTMLMLoss): the transform Dense and LayerNorm, then the vocab
    projection with the cross entropy of each label, by ``mode``:

    * ``"auto"`` (default): ``"chunked"`` while ``MXNET_CHUNKED_CE`` is
      on (its default), else ``"dense"``, read at every forward;
    * ``"chunked"``: ``_contrib_chunked_lm_head_ce``, an online softmax
      over vocab chunks of ``chunk_size`` (0: ``MXNET_CHUNKED_CE_CHUNK``);
    * ``"fused"``: ``_contrib_fused_lm_head_ce``, the full-vocab logits
      recomputed in the backward;
    * ``"dense"``: Dense, log_softmax and pick.

    Takes (seq_out, labels) with seq_out (..., units) and labels of the
    matching leading shape; returns the per-position loss. Parameter
    names equal the reference's, and every mode shares them."""

    def __init__(self, vocab_size=30522, units=768, mode="auto",
                 chunk_size=0, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab_size
        self._mode = mode
        self._chunk = int(chunk_size)
        with self.name_scope():
            self.transform = nn.Dense(units, flatten=False,
                                      in_units=units, prefix="transform_")
            self.layer_norm = nn.LayerNorm(in_channels=units)
            self.head_weight = self.params.get(
                "head_weight", shape=(vocab_size, units))
            self.head_bias = self.params.get(
                "head_bias", shape=(vocab_size,), init="zeros")

    def _resolve_mode(self):
        if self._mode != "auto":
            return self._mode
        return "chunked" if _cfg("MXNET_CHUNKED_CE") else "dense"

    def hybrid_forward(self, F, seq_out, labels, head_weight, head_bias):
        h = self.layer_norm(self.transform(seq_out))
        mode = self._resolve_mode()
        if mode == "chunked":
            return F._contrib_chunked_lm_head_ce(
                h, head_weight, head_bias, labels, chunk_size=self._chunk)
        if mode == "fused":
            return F._contrib_fused_lm_head_ce(h, head_weight, head_bias,
                                               labels)
        logits = F.FullyConnected(h, head_weight, head_bias,
                                  num_hidden=self._vocab, flatten=False)
        logp = F.log_softmax(logits, axis=-1)
        return F.negative(F.pick(logp, labels, axis=-1))


def bert_12_768_12(vocab_size=30522, max_length=512, dropout=0.1, **kwargs):
    """BERT-base: 12 layers, 768 units, 3072 hidden, 12 heads."""
    return BERTModel(num_layers=12, units=768, hidden_size=3072,
                     num_heads=12, max_length=max_length,
                     vocab_size=vocab_size, dropout=dropout, **kwargs)


def bert_24_1024_16(vocab_size=30522, max_length=512, dropout=0.1, **kwargs):
    """BERT-large: 24 layers, 1024 units, 4096 hidden, 16 heads."""
    return BERTModel(num_layers=24, units=1024, hidden_size=4096,
                     num_heads=16, max_length=max_length,
                     vocab_size=vocab_size, dropout=dropout, **kwargs)

