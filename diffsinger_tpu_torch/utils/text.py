"""Phoneme dictionary: multi-language vocab with merged phoneme groups
(own copy of diffsinger_tpu/utils/text.py).

Behavior-compatible with the reference (utils/phoneme_utils.py:10-210):

* index 0 is reserved for PAD;
* ``AP``/``SP`` are always present; ``extra_phonemes`` may add more, optionally
  language-tagged as ``lang/name``;
* in multi-language setups every dictionary phoneme is tagged ``lang/name``;
* ``merged_phoneme_groups`` assign one shared id to a set of aliases; groups that
  span languages form the cross-lingual phoneme set;
* ids are assigned in sorted order of the phoneme tags.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Union

PAD_INDEX = 0


class PhonemeDictionary:
    def __init__(
        self,
        dictionaries: Dict[str, Path],
        extra_phonemes: List[str] | None = None,
        merged_groups: List[List[str]] | None = None,
    ):
        self._multi_langs = len(dictionaries) > 1

        all_phonemes = {"AP", "SP"}
        for ph in extra_phonemes or []:
            if "/" in ph:
                lang, name = ph.split("/", maxsplit=1)
                if lang not in dictionaries:
                    raise ValueError(
                        f"Invalid phoneme tag '{ph}' in extra phonemes: unrecognized language '{lang}'."
                    )
                if name in all_phonemes:
                    raise ValueError(
                        f"Invalid phoneme tag '{ph}' in extra phonemes: conflicts with existing tag."
                    )
            all_phonemes.add(ph)

        for lang, dict_path in dictionaries.items():
            with open(dict_path, "r", encoding="utf8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    _, phones = line.split("\t")
                    for phoneme in phones.split():
                        if "/" in phoneme:
                            raise ValueError(
                                f"Invalid phoneme tag '{phoneme}' in dictionary '{dict_path}': "
                                f"must not contain '/'."
                            )
                        if phoneme in all_phonemes:
                            continue
                        all_phonemes.add(f"{lang}/{phoneme}" if self._multi_langs else phoneme)

        # Normalize merged groups into sets of canonical tags, unioning overlaps.
        groups: List[set] = []
        for group in merged_groups or []:
            tags = set()
            for phoneme in group:
                if "/" in phoneme:
                    lang, name = phoneme.split("/", maxsplit=1)
                    if lang not in dictionaries:
                        raise ValueError(
                            f"Invalid phoneme tag '{phoneme}' in merged group: "
                            f"unrecognized language '{lang}'."
                        )
                    tag = phoneme if self._multi_langs else name
                else:
                    tag = phoneme
                if tag not in all_phonemes:
                    raise ValueError(
                        f"Invalid phoneme tag '{phoneme}' in merged group: not in phoneme set."
                    )
                tags.add(tag)
            if len(tags) <= 1:
                continue
            overlapping = [g for g in groups if g & tags]
            for g in overlapping:
                tags |= g
                groups.remove(g)
            groups.append(tags)

        tag_to_group = {tag: g for g in groups for tag in g}

        phone_to_id: Dict[str, int] = {}
        id_to_phone: List[Union[str, tuple]] = []
        cross_lingual: set = set()
        idx = 1
        for phoneme in sorted(all_phonemes):
            if phoneme in phone_to_id:
                continue
            group = tag_to_group.get(phoneme)
            if group is None:
                phone_to_id[phoneme] = idx
                id_to_phone.append(phoneme)
            else:
                aliases = sorted(group)
                for alias in aliases:
                    phone_to_id[alias] = idx
                id_to_phone.append(tuple(aliases))
                langs = {a.split("/", 1)[0] if "/" in a else None for a in aliases}
                if len(langs) > 1:
                    cross_lingual.update(a for a in aliases if "/" in a)
            idx += 1

        self._phone_to_id = phone_to_id
        self._id_to_phone = id_to_phone
        self._cross_lingual_phonemes = frozenset(cross_lingual)

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_phone) + 1  # +1 for PAD at index 0

    def __len__(self) -> int:
        return self.vocab_size

    @property
    def cross_lingual_phonemes(self):
        return self._cross_lingual_phonemes

    def is_cross_lingual(self, phone: str) -> bool:
        return phone in self._cross_lingual_phonemes

    def encode_one(self, phone: str, lang: str | None = None) -> int:
        if "/" in phone:
            lang, phone = phone.split("/", maxsplit=1)
        if lang is None or not self._multi_langs or phone in self._phone_to_id:
            return self._phone_to_id[phone]
        return self._phone_to_id[f"{lang}/{phone}"]

    def encode(self, sentence: Union[str, Sequence[str]], lang: str | None = None) -> List[int]:
        phones = sentence.strip().split() if isinstance(sentence, str) else sentence
        return [self.encode_one(p, lang=lang) for p in phones]

    def decode_one(self, idx: int, lang: str | None = None, scalar: bool = True):
        if idx <= 0:
            return None
        phone = self._id_to_phone[idx - 1]
        if not scalar or isinstance(phone, str):
            return phone
        if lang is None or not self._multi_langs:
            return phone[0]
        for alias in phone:
            if alias.startswith(f"{lang}/"):
                return alias
        return phone[0]

    def decode(self, ids: Iterable[int], lang: str | None = None, scalar: bool = True) -> str:
        return " ".join(
            self.decode_one(i, lang=lang, scalar=scalar) for i in ids if i >= 1
        )

    def dump(self, filename) -> None:
        with open(filename, "w", encoding="utf8") as fp:
            json.dump(self._phone_to_id, fp, ensure_ascii=False, indent=2)


def load_phoneme_dictionary(hparams: dict) -> PhonemeDictionary:
    """Locate dictionary files per the reference's search order
    (utils/phoneme_utils.py:180-210): work-dir copies win over config paths."""
    work_dir = Path(hparams.get("work_dir") or ".")
    config_dicts = hparams.get("dictionaries")
    repo_root = Path(__file__).resolve().parents[2]

    def resolve(p) -> Path:
        p = Path(p)
        if p.exists():
            return p
        candidate = repo_root / p
        if candidate.exists():
            return candidate
        raise FileNotFoundError(f"Could not locate dictionary file: {p}")

    if config_dicts:
        dicts = {}
        for lang, config_path in config_dicts.items():
            path = work_dir / f"dictionary-{lang}.txt"
            dicts[lang] = path if path.exists() else resolve(config_path)
    else:
        path = work_dir / "dictionary.txt"
        if not path.exists():
            path = resolve(hparams["dictionary"])
        dicts = {"default": path}
    return PhonemeDictionary(
        dictionaries=dicts,
        extra_phonemes=hparams.get("extra_phonemes"),
        merged_groups=hparams.get("merged_phoneme_groups"),
    )
