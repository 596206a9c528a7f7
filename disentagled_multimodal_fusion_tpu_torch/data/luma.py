"""LUMA 3-modality dataset (audio / text / image): the compiled-corpus loader,
its offline featurization pass and the test fixture.

Counterpart of ``disentagled_multimodal_fusion_tpu/data/luma.py``, with the
same features bit for bit and no pandas or PyYAML at module level, so it runs
on a machine that has neither. The compiled directory holds:

* ``audio_datalist.csv`` (filepath, label) and ``text_data.tsv`` (text,
  label), read with the standard ``csv`` module; a row's index is its
  position, as ``pandas.read_csv`` gives it, and a text cell that pandas
  reads as missing (``""``, ``NA``, ``nan``, ...) featurizes as ``"nan"``,
  as ``str()`` of pandas' NaN does;
* ``edm_images.pickle``, a pickled DataFrame ('image' (32, 32, 3) uint8,
  'label'), read through a lazy pandas import; :func:`make_fake_luma` also
  writes the same rows as ``edm_images.npz`` (uint8 ``image`` (N, 32, 32, 3)
  and ``label``), which is read when pandas cannot be imported;
* ``metadata.yaml`` (num_classes, num_ood_classes, the optional
  ``ood_classes`` list and split sizes), read through a lazy PyYAML import
  or, without it, a reader of the flat mapping of scalars and string lists
  that ``yaml.safe_dump`` writes there.

Features (the JAX package's docstring has the reference lines):

* audio: wav -> 16 kHz -> mono -> pad/trim 3 s -> 40-MFCC -> time-mean
  (``data/audio.py``, or the native featurizer), or the (n_mfcc, frames)
  map with ``use_2d``;
* text: BERT token ids / vocab size, padded to 128, from transformers'
  tokenizer, else the vendored WordPiece over a local vocab, else
  ``hash(word) % 10000 / 10000`` with a warning (Python salts ``hash`` per
  process: fix ``PYTHONHASHSEED`` to compare text features across
  processes);
* image: (32, 32, 3) -> /255 -> ImageNet normalisation -> CHW flatten to
  3072; a gray placeholder with ``replicate_image_bug`` (the reference's
  dropped ``image_idx``).

Featurization runs once and is cached to
``features_{split}{tag}_{crc}.npz`` beside the data, keyed on every setting
that changes the features and on the class order.
"""

from __future__ import annotations

import csv
import json
import os
import warnings
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the strings pandas.read_csv reads as missing by default
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _hash_tokenize(text: str, max_length: int) -> np.ndarray:
    words = str(text).lower().split()
    ids = [hash(w) % 10000 for w in words[:max_length]]
    ids += [0] * (max_length - len(ids))
    return np.asarray(ids, np.float32) / 10000.0


class Table:
    """Columns of a delimited file as lists, rows indexed by position."""

    def __init__(self, columns: Dict[str, list]):
        self.columns = columns

    @classmethod
    def read(cls, path: Path, delimiter: str = ",") -> "Table":
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter=delimiter)
            header = next(reader)
            cols = {name: [] for name in header}
            for row in reader:
                for name, value in zip(header, row):
                    cols[name].append(value)
        return cls(cols)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def rows_of(self, label) -> List[int]:
        """Indices of the rows whose label is ``label``, in file order."""
        return [i for i, lbl in enumerate(self.columns["label"]) if lbl == label]


def _scalar(text: str):
    """A plain YAML scalar as ``yaml.safe_load`` reads the ones
    ``yaml.safe_dump`` writes for the metadata."""
    t = text.strip()
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        body = t[1:-1]
        return body.replace("''", "'") if t[0] == "'" else json.loads(t)
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t


def parse_block_yaml(text: str) -> dict:
    """The mapping of scalars, lists of scalars and nested mappings (by
    indentation) that ``yaml.safe_dump`` writes for a metadata dict or a
    compile config (``dump_yaml``)."""
    root: dict = {}
    stack = [(-1, root)]  # (indent of the key that owns the mapping, mapping)
    open_key = None       # (indent, mapping, key) of the last key without a value
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        indent = len(line) - len(line.lstrip(" "))
        stripped = line.strip()
        if stripped.startswith("- ") or stripped == "-":
            if open_key is None:
                raise ValueError(f"a list item outside a key: {line!r}")
            _, mapping, key = open_key
            if not isinstance(mapping[key], list):
                mapping[key] = []
            mapping[key].append(_scalar(stripped[1:]))
            continue
        if ":" not in stripped:
            raise ValueError(f"not a YAML mapping line: {line!r}")
        if open_key is not None and indent > open_key[0] and open_key[1][open_key[2]] is None:
            child: dict = {}
            open_key[1][open_key[2]] = child
            stack.append((open_key[0], child))
        while stack[-1][0] >= indent:
            stack.pop()
        mapping = stack[-1][1]
        key, _, value = stripped.partition(":")
        key, value = key.strip(), value.strip()
        open_key = None
        if value == "[]":
            mapping[key] = []
        elif value == "{}":
            mapping[key] = {}
        elif value == "":
            mapping[key] = None  # a list or mapping may follow
            open_key = (indent, mapping, key)
        else:
            mapping[key] = _scalar(value)
    return root


def read_metadata(path: Path) -> dict:
    """``metadata.yaml`` through PyYAML, or :func:`parse_block_yaml` without it."""
    text = path.read_text()
    try:
        import yaml
    except ImportError:
        return parse_block_yaml(text) or {}
    return yaml.safe_load(text) or {}


class ImageTable:
    """The image table: an 'image' per row, its 'label' and its index label
    (the pickled DataFrame's index; the row position for ``.npz``)."""

    def __init__(self, images, labels: list, index: list):
        self.images, self.labels, self.index = images, labels, index
        self._at = {k: i for i, k in enumerate(index)}

    @classmethod
    def load(cls, data_path: Path) -> Optional["ImageTable"]:
        """``edm_images.pickle`` through pandas, else ``edm_images.npz``;
        None (with a warning) when neither can be read."""
        pkl, npz = data_path / "edm_images.pickle", data_path / "edm_images.npz"
        if pkl.exists():
            try:
                import pandas as pd
            except ImportError:
                pd = None
            if pd is not None:
                df = pd.read_pickle(pkl)
                return cls(list(df["image"]), list(df["label"]), list(df.index))
        if npz.exists():
            z = np.load(npz, allow_pickle=False)
            labels = [str(x) for x in z["label"]]
            return cls(z["image"], labels, list(range(len(labels))))
        warnings.warn(f"EDM images not found at {pkl} (or {npz} without pandas)")
        return None

    def rows_of(self, label) -> List[int]:
        return [i for i, lbl in enumerate(self.labels) if lbl == label]

    def image(self, index_label) -> np.ndarray:
        return np.asarray(self.images[self._at[index_label]], dtype=np.uint8)


class LUMADataset:
    """Compiled-LUMA loader exposing dense, featurized arrays."""

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        audio_config: Optional[Dict] = None,
        text_config: Optional[Dict] = None,
        image_config: Optional[Dict] = None,
        use_ood: bool = False,
        replicate_image_bug: bool = False,
        train_per_class: int = 500,
        test_per_class: int = 100,
        cache: bool = True,
    ):
        self.data_path = Path(data_path)
        self.split = split
        self.use_ood = use_ood
        self.replicate_image_bug = replicate_image_bug
        self.train_per_class = train_per_class
        self.test_per_class = test_per_class
        self.cache = cache
        self.audio_config = audio_config or {
            "sample_rate": 16000, "max_length": 3.0, "n_mfcc": 40, "use_mfcc": True,
        }
        self.text_config = text_config or {
            "max_length": 128, "model_name": "bert-base-uncased", "use_pretrained": True,
        }
        self.image_config = image_config or {"size": (32, 32), "normalize": True}
        self._load_metadata()
        self._load_frames()
        self._organize_by_class()
        self._tokenizer = None

    # ------------------------------------------------------------- loading
    def _load_metadata(self):
        meta = self.data_path / "metadata.yaml"
        if meta.exists():
            m = read_metadata(meta)
            self.num_classes = m.get("num_classes", 42)
            self.num_ood_classes = m.get("num_ood_classes", 8)
            self.ood_class_names = m.get("ood_classes")
            self.train_per_class = m.get("train_samples_per_class", self.train_per_class)
            self.test_per_class = m.get("test_samples_per_class", self.test_per_class)
        else:
            self.num_classes, self.num_ood_classes = 42, 8
            self.ood_class_names = None

    def _load_frames(self):
        audio_csv = self.data_path / "audio_datalist.csv"
        if not audio_csv.exists():
            raise FileNotFoundError(f"Audio datalist not found at {audio_csv}")
        self.audio = Table.read(audio_csv)
        text_tsv = self.data_path / "text_data.tsv"
        if not text_tsv.exists():
            raise FileNotFoundError(f"Text data not found at {text_tsv}")
        self.text = Table.read(text_tsv, delimiter="\t")
        self.images = ImageTable.load(self.data_path)

    def _organize_by_class(self):
        audio_labels = set(self.audio.columns["label"])
        has_text_label = "label" in self.text
        text_labels = set(self.text.columns["label"]) if has_text_label else audio_labels
        common = sorted(audio_labels & text_labels)
        if self.ood_class_names is not None:
            # the manifest's OOD classes follow the ID ones, whatever their names
            ood = sorted(set(common) & set(self.ood_class_names))
            ids = [c for c in common if c not in set(ood)]
        else:
            # no manifest: the alphabetical tail beyond num_classes is OOD
            ids, ood = common[: self.num_classes], common[self.num_classes:]
        self.num_id_classes = len(ids)
        self.classes = ids + ood if self.use_ood else ids
        self.num_classes = len(self.classes)
        self.label_to_idx = {lbl: i for i, lbl in enumerate(self.classes)}

        tr, te = self.train_per_class, self.test_per_class
        cut = slice(0, tr) if self.split == "train" else slice(tr, tr + te)
        self.samples: List[dict] = []
        for lbl in self.classes:
            a = self.audio.rows_of(lbl)[cut]
            t = self.text.rows_of(lbl)[cut] if has_text_label else None
            im = None
            if self.images is not None:
                im = [self.images.index[i] for i in self.images.rows_of(lbl)][cut]
            for i in range(len(a)):
                self.samples.append({
                    "audio_idx": a[i],
                    # without a label column the reference uses the within-class
                    # position as a global row index (kept verbatim)
                    "text_idx": t[i] if t is not None else i,
                    "image_idx": im[i] if im is not None and i < len(im) else -1,
                    "label": self.label_to_idx[lbl],
                    "class_name": lbl,
                })

    def __len__(self):
        return len(self.samples)

    @property
    def num_views(self) -> int:
        return 3

    @property
    def dims(self) -> np.ndarray:
        return np.array([
            [self.audio_config["n_mfcc"]],
            [self.text_config["max_length"]],
            [self.image_config["size"][0] * self.image_config["size"][1] * 3],
        ])

    # -------------------------------------------------------- featurization
    def _get_tokenizer(self):
        """transformers' tokenizer (local files only), else the vendored
        WordPiece over a local vocab, else False (the hash fallback, with a
        warning): the JAX package's order."""
        if self._tokenizer is None and self.text_config.get("use_pretrained", True):
            try:
                from transformers import AutoTokenizer

                self._tokenizer = AutoTokenizer.from_pretrained(
                    self.text_config["model_name"], local_files_only=True)
            except Exception:
                from .wordpiece import WordPieceTokenizer, find_local_vocab

                vocab = find_local_vocab(self.text_config.get("vocab_file"))
                if vocab is not None:
                    self._tokenizer = WordPieceTokenizer.from_vocab_file(vocab)
                    print(f"[luma] offline WordPiece tokenizer: {vocab} "
                          f"({self._tokenizer.vocab_size} tokens)", flush=True)
                else:
                    warnings.warn(
                        "LUMA TEXT FEATURES DIVERGE FROM THE REFERENCE: no HF cache and no "
                        "vendored BERT vocab found — falling back to hash token-IDs. Vendor "
                        "the bert-base-uncased vocab at data/bert-base-uncased-vocab.txt (or "
                        "set text.vocab_file) for reference-identical features.",
                        stacklevel=2,
                    )
                    self._tokenizer = False
        return self._tokenizer or None

    def _text_of(self, row: int) -> str:
        value = self.text.columns["text"][row]
        return "nan" if value in PANDAS_NA else value

    def _featurize_text(self) -> np.ndarray:
        from .wordpiece import WordPieceTokenizer

        max_len = self.text_config["max_length"]
        tok = self._get_tokenizer()
        out = np.zeros((len(self.samples), max_len), np.float32)
        for i, s in enumerate(self.samples):
            text = self._text_of(s["text_idx"])
            if isinstance(tok, WordPieceTokenizer):
                out[i] = np.asarray(tok.encode(text, max_len), np.float32) / tok.vocab_size
            elif tok is not None:
                enc = tok(text, max_length=max_len, padding="max_length", truncation=True,
                          return_tensors="np")
                out[i] = enc["input_ids"][0].astype(np.float32) / tok.vocab_size
            else:
                out[i] = _hash_tokenize(text, max_len)
        return out

    def _featurize_audio(self) -> np.ndarray:
        from .native_featurizer import featurize_wav_files

        paths = []
        for s in self.samples:
            fp = Path(self.audio.columns["filepath"][s["audio_idx"]])
            paths.append(str(fp if fp.is_absolute() else self.data_path / fp))
        cfg = self.audio_config
        if cfg.get("use_2d", False):
            from .audio import wav_to_mfcc_map

            return np.stack([
                wav_to_mfcc_map(p, sample_rate=cfg["sample_rate"],
                                max_length_s=cfg["max_length"], n_mfcc=cfg["n_mfcc"])
                for p in paths
            ])
        return featurize_wav_files(paths, sample_rate=cfg["sample_rate"],
                                   max_length_s=cfg["max_length"], n_mfcc=cfg["n_mfcc"])

    def _featurize_images(self) -> np.ndarray:
        h, w = self.image_config["size"]
        out = np.zeros((len(self.samples), h * w * 3), np.float32)
        gray = np.full((h, w, 3), 128, np.uint8)
        for i, s in enumerate(self.samples):
            idx = -1 if self.replicate_image_bug else s.get("image_idx", -1)
            arr = self.images.image(idx) if self.images is not None and idx != -1 else gray
            img = arr.astype(np.float32) / 255.0
            if self.image_config.get("normalize", True):
                img = (img - IMAGENET_MEAN) / IMAGENET_STD
            out[i] = img.transpose(2, 0, 1).reshape(-1)  # CHW flatten
        return out

    def cache_file(self) -> Path:
        """``features_{split}{tag}_{crc}.npz``: the crc covers every setting
        that changes the features and the class order."""
        tag = ("_ood" if self.use_ood else "") + (
            "_2d" if self.audio_config.get("use_2d", False) else "")
        digest = zlib.crc32(json.dumps(
            {
                "audio": self.audio_config,
                "text": self.text_config,
                "image": self.image_config,
                "image_bug": self.replicate_image_bug,
                "classes": list(self.classes),
            },
            sort_keys=True, default=str,
        ).encode())
        return self.data_path / f"features_{self.split}{tag}_{digest:08x}.npz"

    def featurize(self) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], np.ndarray]:
        """((audio, text, image), labels), cached (unless ``cache`` is off)."""
        cache_file = self.cache_file()
        if self.cache and cache_file.exists():
            z = np.load(cache_file)
            return (z["audio"], z["text"], z["image"]), z["y"]
        audio = self._featurize_audio()
        text = self._featurize_text()
        image = self._featurize_images()
        y = np.asarray([s["label"] for s in self.samples], np.int64)
        if self.cache:
            # through a file of this process's own and a rename: ranks that
            # featurize one corpus at once never read a file half written
            tmp = cache_file.with_name(f"{cache_file.name}.{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                np.savez_compressed(f, audio=audio, text=text, image=image, y=y)
            os.replace(tmp, cache_file)
        return (audio, text, image), y


def get_luma_arrays(data_path: str, audio_config=None, text_config=None, image_config=None,
                    use_ood: bool = False, **dataset_kwargs):
    """Featurized train/test arrays: (train_views, train_y, test_views,
    test_y, num_classes, num_views, dims)."""
    train = LUMADataset(data_path, "train", audio_config, text_config, image_config,
                        use_ood=use_ood, **dataset_kwargs)
    test = LUMADataset(data_path, "test", audio_config, text_config, image_config,
                       use_ood=use_ood, **dataset_kwargs)
    xs_tr, y_tr = train.featurize()
    xs_te, y_te = test.featurize()
    return xs_tr, y_tr, xs_te, y_te, train.num_classes, train.num_views, train.dims


def get_luma_ood_arrays(data_path: str, audio_config=None, text_config=None, image_config=None,
                        **dataset_kwargs):
    """Featurized test rows of the held-out OOD classes: (ood_views,
    ood_labels, num_id_classes); every label is >= num_id_classes, and the
    arrays are empty when the corpus has no extra classes."""
    ds = LUMADataset(data_path, "test", audio_config, text_config, image_config, use_ood=True,
                     **dataset_kwargs)
    xs, y = ds.featurize()
    keep = y >= ds.num_id_classes
    return tuple(x[keep] for x in xs), y[keep], ds.num_id_classes


# ------------------------------------------------------------ YAML writer
def _yaml_scalar(value) -> str:
    """A scalar as ``yaml.safe_dump`` writes the plain ones; any other
    string double-quoted (JSON's escapes, which YAML reads)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return repr(value)
    if isinstance(value, float):
        mantissa, e, exp = repr(value).partition("e")
        # YAML 1.1 reads a float's exponent only after a point: 1.0e-05
        return mantissa + (".0" if e and "." not in mantissa else "") + e + exp
    text = str(value)
    plain = (text and all(c.isalnum() or c in "_./-" for c in text) and text[0] not in "-."
             and _scalar(text) == text)
    return text if plain else json.dumps(text)


def dump_yaml(data: dict, sort_keys: bool = True, indent: int = 0) -> str:
    """``yaml.safe_dump(data, sort_keys=...)`` for nested mappings of
    scalars and lists of scalars, without PyYAML: block style, two spaces
    per level, list items at their key's indent. :func:`parse_block_yaml`
    reads it back."""
    pad, lines = " " * indent, []
    for key in (sorted(data) if sort_keys else data):
        value = data[key]
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{key}:")
            lines.append(dump_yaml(value, sort_keys, indent + 2).rstrip("\n"))
        elif isinstance(value, (list, tuple)) and value:
            lines.append(f"{pad}{key}:")
            lines.extend(f"{pad}- {_yaml_scalar(item)}" for item in value)
        elif isinstance(value, (dict, list, tuple)):
            lines.append(f"{pad}{key}: {'{}' if isinstance(value, dict) else '[]'}")
        else:
            lines.append(f"{pad}{key}: {_yaml_scalar(value)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ test fixture


def make_fake_luma(root: str, n_classes: int = 4, train_per_class: int = 6,
                   test_per_class: int = 2, sample_rate: int = 8000, seed: int = 0,
                   ood_classes: int = 0) -> str:
    """Write a compiled-format LUMA corpus (real wavs, csv, tsv, metadata and
    the image table) with the JAX package's fixture rows, draw for draw;
    ``ood_classes`` adds held-out classes beyond ``n_classes`` (the real
    corpus's 42 + 8 layout). The image table is written as ``edm_images.npz``
    and, where pandas can be imported, also as ``edm_images.pickle``."""
    import wave

    rng = np.random.default_rng(seed)
    root = Path(root)
    (root / "audio").mkdir(parents=True, exist_ok=True)
    per_class = train_per_class + test_per_class
    rows_a, rows_t, images, img_labels = [], [], [], []
    for c in range(n_classes + ood_classes):
        label = f"class_{c}"
        for i in range(per_class):
            rel = f"audio/{label}_{i}.wav"
            freq = 200.0 + 60.0 * c
            t = np.arange(int(sample_rate * 0.5)) / sample_rate
            sig = np.sin(2 * np.pi * freq * t) * 0.3 + rng.standard_normal(t.size) * 0.01
            with wave.open(str(root / rel), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes((sig * 32767).astype("<i2").tobytes())
            rows_a.append((rel, label))
            rows_t.append((f"a sample of {label} number {i}", label))
            img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            img[:, :, c % 3] = min(40 * c + 40, 255)  # class-colored channel
            images.append(img)
            img_labels.append(label)

    for name, header, rows, delimiter in (("audio_datalist.csv", ("filepath", "label"), rows_a, ","),
                                          ("text_data.tsv", ("text", "label"), rows_t, "\t")):
        with open(root / name, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f, delimiter=delimiter, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(rows)
    np.savez(root / "edm_images.npz", image=np.stack(images), label=np.asarray(img_labels))
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        pd.DataFrame({"image": images, "label": img_labels}).to_pickle(root / "edm_images.pickle")
    meta = {
        "num_classes": n_classes,
        "num_ood_classes": ood_classes,
        "train_samples_per_class": train_per_class,
        "test_samples_per_class": test_per_class,
    }
    if ood_classes:
        meta["ood_classes"] = [f"class_{c}" for c in range(n_classes, n_classes + ood_classes)]
    (root / "metadata.yaml").write_text(dump_yaml(meta))
    return str(root)
