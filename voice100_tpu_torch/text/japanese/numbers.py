"""Japanese readings for ASCII numerals and numeral+counter pairs.

The reference reads numbers through MeCab, which yields proper
counter-aware readings (voice100/japanese/phonemizer.py:355-380); the
hermetic fallback previously dropped ASCII digit runs entirely and then
misread the following counter kanji as an isolated kun (年 -> トシ).
This module provides cardinal readings up to 10^8 and the irregular
counter paradigms that dominate everyday/dated text (月日時分人 plus
the geminating counters 回個本匹歳階杯冊).

Sound changes implemented (standard Sino-Japanese counter euphony):
* イチ/ハチ/ジュウ + unvoiced obstruent -> geminate (イッカイ,
  ハッポン, ジュッサイ), h-row hardening to p-row;
* ロク + k/h/p -> geminate (ロッカイ, ロッポン);
* サン/ナン + h-row -> p-row (サンプン) — except 本, which voices to
  b-row (サンボン).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["read_number", "read_with_counter", "COUNTERS",
           "counter_reading", "kanji_numeral_span",
           "kanji_numeral_to_int"]

_DIGITS = ["ゼロ", "イチ", "ニ", "サン", "ヨン", "ゴ",
           "ロク", "ナナ", "ハチ", "キュウ"]

_HUNDREDS = {3: "サンビャク", 6: "ロッピャク", 8: "ハッピャク"}
_THOUSANDS = {3: "サンゼン", 8: "ハッセン"}


def _under_10000(n: int) -> str:
    out = []
    k, n = divmod(n, 1000)
    if k:
        out.append(_THOUSANDS.get(k, ("" if k == 1 else _DIGITS[k]) + "セン"))
    k, n = divmod(n, 100)
    if k:
        out.append(_HUNDREDS.get(k, ("" if k == 1 else _DIGITS[k]) + "ヒャク"))
    k, n = divmod(n, 10)
    if k:
        out.append(("" if k == 1 else _DIGITS[k]) + "ジュウ")
    if n:
        out.append(_DIGITS[n])
    return "".join(out)


def read_number(digits: str) -> str:
    """Cardinal reading of an ASCII digit string (ゼロ for 0; groups of
    万/億; very long runs read digit-by-digit like a phone number)."""
    if len(digits) > 9:
        return "".join(_DIGITS[int(d)] for d in digits)
    n = int(digits)
    if n == 0:
        return "ゼロ"
    out = []
    k, n = divmod(n, 100_000_000)
    if k:
        out.append(_under_10000(k) + "オク")
    k, n = divmod(n, 10_000)
    if k:
        # 10000 is イチマン (unlike 1000 = セン)
        out.append(_under_10000(k) + "マン")
    if n:
        out.append(_under_10000(n))
    return "".join(out)


# generic counters: reading + whether a final イチ/ハチ/ジュウ(/ロク)
# geminates into its head consonant
_GEMINATING = {"回": "カイ", "個": "コ", "本": "ホン", "匹": "ヒキ",
               "歳": "サイ", "階": "カイ", "杯": "ハイ", "冊": "サツ",
               "分": "フン", "秒": "ビョウ", "軒": "ケン", "頭": "トウ",
               "足": "ソク"}
_PLAIN = {"年": "ネン", "円": "エン", "番": "バン", "枚": "マイ",
          "台": "ダイ", "度": "ド", "点": "テン", "名": "メイ",
          "語": "ゴ", "件": "ケン", "倍": "バイ", "歩": "ホ",
          "割": "ワリ"}

COUNTERS = set(_GEMINATING) | set(_PLAIN) | {"月", "日", "時", "人"}

_MONTHS = {1: "イチ", 2: "ニ", 3: "サン", 4: "シ", 5: "ゴ", 6: "ロク",
           7: "シチ", 8: "ハチ", 9: "ク", 10: "ジュウ",
           11: "ジュウイチ", 12: "ジュウニ"}
_DAYS = {1: "ツイタチ", 2: "フツカ", 3: "ミッカ", 4: "ヨッカ",
         5: "イツカ", 6: "ムイカ", 7: "ナノカ", 8: "ヨウカ",
         9: "ココノカ", 10: "トオカ", 14: "ジュウヨッカ", 20: "ハツカ",
         24: "ニジュウヨッカ"}
_HOURS = {4: "ヨ", 7: "シチ", 9: "ク"}

_P_ROW = {"ハ": "パ", "ヒ": "ピ", "フ": "プ", "ヘ": "ペ", "ホ": "ポ"}
_UNVOICED = set("カキクケコサシスセソタチツテトハヒフヘホ")


def _join_geminate(num: str, counter: str) -> str:
    """number reading + geminating counter with standard euphony."""
    head = counter[0]
    if num.endswith(("イチ", "ハチ")) and head in _UNVOICED:
        return num[:-1] + "ッ" + _P_ROW.get(head, head) + counter[1:]
    if num.endswith("ジュウ") and head in _UNVOICED:
        return num[:-1] + "ッ" + _P_ROW.get(head, head) + counter[1:]
    if (
        num.endswith(("ロク", "ヒャク", "ピャク", "ビャク"))
        and head in "カキクケコハヒフヘホパピプペポ"
    ):
        # k/h/p-initial counters geminate after ク (ロッカイ,
        # ヒャッピキ, ロッピャッピキ)
        return num[:-1] + "ッ" + _P_ROW.get(head, head) + counter[1:]
    if num.endswith("ン") and head in _P_ROW:
        # 本 voices to b-row after ン (サンボン); others harden to
        # p-row (サンプン, ナンプン)
        if counter == "ホン":
            return num + "ボ" + counter[1:]
        return num + _P_ROW[head] + counter[1:]
    return num + counter


def counter_reading(counter: str) -> Optional[str]:
    """Canonical (euphony-free) reading of a counter kanji, used to
    split compounds that start with a counter (年前=ネンマエ after a
    numeral reads as numeral+ネン, then マエ)."""
    special = {"月": "ガツ", "日": "ニチ", "時": "ジ", "人": "ニン"}
    if counter in special:
        return special[counter]
    return _GEMINATING.get(counter) or _PLAIN.get(counter)


# kanji numerals: positional strings (一九九五) and magnitude strings
# (三十五, 百二十, 一万二千) both occur before counters
_KANJI_DIGIT = {"〇": 0, "零": 0, "一": 1, "二": 2, "三": 3, "四": 4,
                "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_KANJI_MAG = {"十": 10, "百": 100, "千": 1000}
_KANJI_NUMERALS = set(_KANJI_DIGIT) | set(_KANJI_MAG) | {"万"}


def kanji_numeral_span(text: str, i: int) -> int:
    """Length of the kanji-numeral run starting at ``i`` (0 if none)."""
    j = i
    while j < len(text) and text[j] in _KANJI_NUMERALS:
        j += 1
    return j - i


def kanji_numeral_to_int(s: str) -> Optional[int]:
    """Value of a kanji numeral string, or None if it isn't one.

    All-digit strings read positionally (一九九五 = 1995); strings with
    magnitude kanji read multiplicatively (三十五 = 35, 一万二千 =
    12000, bare 十/百/千 = their magnitude).
    """
    if not s or any(c not in _KANJI_NUMERALS for c in s):
        return None
    if all(c in _KANJI_DIGIT for c in s):
        return int("".join(str(_KANJI_DIGIT[c]) for c in s))
    total = cur = man = 0
    for c in s:
        if c in _KANJI_DIGIT:
            cur = cur * 10 + _KANJI_DIGIT[c]
        elif c in _KANJI_MAG:
            total += (cur or 1) * _KANJI_MAG[c]
            cur = 0
        else:  # 万
            man += ((total + cur) or 1) * 10_000
            total = cur = 0
    return man + total + cur


def read_with_counter(digits: str, counter: str) -> Optional[str]:
    """Reading of ``<digits><counter-kanji>`` or None if the counter
    has no entry (caller falls back to plain handling)."""
    if not digits.isdigit():
        return None
    n = int(digits)
    if counter == "月" and 1 <= n <= 12:
        return _MONTHS[n] + "ガツ"
    if counter == "日":
        if n in _DAYS:
            return _DAYS[n]
        return read_number(digits) + "ニチ"
    if counter == "時":
        if n in _HOURS:
            return _HOURS[n] + "ジ"
        return read_number(digits) + "ジ"
    if counter == "人":
        if n == 1:
            return "ヒトリ"
        if n == 2:
            return "フタリ"
        if n == 4:
            return "ヨニン"
        return read_number(digits) + "ニン"
    if counter == "歳" and n == 20:
        return "ハタチ"
    if counter in _GEMINATING:
        num = read_number(digits)
        if counter == "階" and num.endswith("ン"):
            # lexical rendaku: 3階 = サンガイ (回 stays サンカイ)
            return num + "ガイ"
        if counter == "足" and num.endswith("ン"):
            # lexical rendaku: 3足 = サンゾク (pairs of footwear)
            return num + "ゾク"
        return _join_geminate(num, _GEMINATING[counter])
    if counter in _PLAIN:
        num = read_number(digits)
        if counter == "年" and num.endswith("ヨン"):
            # years read 四 as ヨ (2024年 = ...ニジュウヨネン)
            num = num[:-1]
        return num + _PLAIN[counter]
    return None
