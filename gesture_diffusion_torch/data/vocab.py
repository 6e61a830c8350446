"""Word vocabulary for the prep phase.

A copy of ``gesture_diffusion_tpu/data/vocab.py`` (numpy only), kept here
so the port never imports the JAX package: word<->index maps with reserved
PAD/SOS/EOS/UNK ids, and an optional embedding table loaded from a
.npy/.npz word-vector dump.  A vocab pickled by the port unpickles as this
class, one pickled by the JAX package as the JAX one: the contents are the
same, the module path differs.
"""

from __future__ import annotations

import numpy as np

PAD_token, SOS_token, EOS_token, UNK_token = 0, 1, 2, 3


class Vocab:
    def __init__(self, name: str):
        self.name = name
        self.word2index = {}
        self.index2word = {
            PAD_token: "<PAD>", SOS_token: "<SOS>",
            EOS_token: "<EOS>", UNK_token: "<UNK>"}
        self.n_words = len(self.index2word)
        self.word_embeddings = None

    def index_word(self, word: str) -> int:
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.index2word[self.n_words] = word
            self.n_words += 1
        return self.word2index[word]

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, UNK_token)

    def load_word_vectors(self, path: "str | None", dim: int = 300) -> None:
        """Attach pretrained vectors from an .npz {word: vec} dump; absent
        path -> random-normal embeddings on demand."""
        self._pretrained_path = path
        self._dim = dim

    def build_embedding_table(self, rng: np.random.Generator) -> np.ndarray:
        # dim defaults like load_word_vectors' so a vocab that never called
        # it (or was unpickled from one) still gets random embeddings
        dim = getattr(self, "_dim", 300)
        table = rng.normal(0, 0.1, (self.n_words, dim)).astype(np.float32)
        if getattr(self, "_pretrained_path", None):
            z = np.load(self._pretrained_path, allow_pickle=True)
            try:
                # .npy of a pickled {word: vec} dict arrives as a 0-d
                # object array; .npz exposes the mapping directly
                if isinstance(z, np.ndarray):
                    if z.shape != () or not isinstance(z.item(), dict):
                        raise ValueError(
                            f"{self._pretrained_path}: expected an .npz "
                            "word->vector archive or an .npy pickled "
                            "{word: vec} dict, got a plain array of shape "
                            f"{z.shape} (dtype {z.dtype})")
                    vecs = z.item()
                else:
                    vecs = z
                for word, idx in self.word2index.items():
                    if word in vecs:
                        table[idx] = vecs[word]
            finally:
                getattr(z, "close", lambda: None)()
        self.word_embeddings = table
        return table
