"""Japanese text -> katakana reading (yomi).

The reference obtains readings from MeCab via fugashi
(voice100/japanese/phonemizer.py:355-380). This module keeps the same
token-level policy but makes the reading source pluggable:

* ``MecabReader`` — used automatically when ``fugashi`` is importable
  (full coverage, identical to the reference).
* ``LexiconReader`` — hermetic fallback: kana passes through, a
  longest-match embedded lexicon covers common words/phrases, and a
  single-kanji reading table catches the rest. Unknown tokens pass
  through unchanged (the reference does the same for words MeCab cannot
  read), and downstream cleanup drops what the vocabulary cannot encode.

For production-quality Japanese corpora install ``fugashi`` + a dictionary.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from .kana import hira2kata
from .numbers import (COUNTERS, counter_reading, kanji_numeral_span,
                      kanji_numeral_to_int, read_number,
                      read_with_counter)
from .readings import COMPOUNDS, KUN, KUN_OKURI, ON

__all__ = ["text2kata"]

_SYMBOL_TOKENS = set("・、。？！")
_NO_YOMI_TOKENS = set("「」『』―（）［］[]　…")

_HIRA_RX = re.compile(r"[ぁ-んー]+")

# --- Sino-Japanese euphony at on-on jukugo boundaries ---------------------
# MeCab reads whole words so it never needs these; the per-kanji
# fallback concatenates morpheme readings and must apply the productive
# sound changes (sokuonbin gemination, post-nasal h->p):
#   ハツ+ヒョウ -> ハッピョウ, イチ+タイ -> イッタイ, コク+カ -> コッカ,
#   ラン+ハク -> ランパク.
_P_ROW = {"ハ": "パ", "ヒ": "ピ", "フ": "プ", "ヘ": "ペ", "ホ": "ポ"}
_UNVOICED_HEADS = set("カキクケコサシスセソタチツテトハヒフヘホパピプペポ")
# readings whose post-ン outcome is lexically voiced (b-row) or
# unchanged, not the productive p-row: keep them as-is
# (三百=サンビャク, 南北=ナンボク, 三本=サンボン)
_NP_KEEP = {"ヒャク", "ホク", "ホン"}

# hiragana that opens a POST-NOUN function word (case particle, topic
# marker, copula) rather than okurigana: a multi-kanji run ending right
# before one of these is a jukugo noun (発表は = ハッピョウ+ワ), not a
# verb stem — its final kanji must read ON, not KUN. Inflection heads
# (る/す/た/し/...) are absent from this set on purpose: 手伝う, 見送る
# keep their kun stems.
_PARTICLE_HEADS = set("はをがのでともへやかだねよに")

# two-character particles that mark the preceding multi-kanji run as a
# noun just like the single-char heads above (月末まで = ゲツマツ, not
# a スエ verb stem). から is deliberately absent: 分からない would
# misread (から there is okurigana of the negative stem).
_PARTICLE_PAIRS = ("まで", "など", "だけ", "しか", "より", "こそ")

# numeral and prefix kanji that read ON before a katakana loanword
_ON_PREFIX_KANJI = set("一二三四五六七八九十百千万新超大全各約元非再最")

# hiragana demonstratives/pronouns that a topic/directional particle
# commonly follows inside one hiragana run (こちらへ, これは)
_DEMONSTRATIVES = (
    "こちら", "そちら", "あちら", "どちら", "これ", "それ", "あれ",
    "どれ", "ここ", "そこ", "どこ", "うち", "わたし", "ぼく", "みんな",
)


def _euphonic_join(prev: str, nxt: str, even_boundary: bool = True):
    """Adjust an (on, on) reading pair at a morpheme boundary.

    ``even_boundary`` is True when the left kanji sits at an even
    offset within its jukugo segment: sound changes bind the 0-1 pair
    of a two-kanji word (学校=ガッコウ, 発表=ハッピョウ) but NOT the
    word seam of a 2+2 compound (建設工事=ケンセツコウジ,
    新聞配達=シンブンハイタツ stay unchanged at the 1-2 boundary)."""
    if not prev or not nxt or not even_boundary:
        return prev, nxt
    head = nxt[0]
    # gemination: a final tsu/chi assimilates into a following unvoiced
    # obstruent (and h-row hardens to p-row): ハツ+ケン -> ハッケン,
    # シツ+ハイ -> シッパイ. Single-mora readings (地=チ) never geminate.
    if len(prev) >= 2 and prev[-1] in "ツチ" and head in _UNVOICED_HEADS:
        return prev[:-1] + "ッ", _P_ROW.get(head, head) + nxt[1:]
    # ku before k-row: ガク+コウ -> ガッコウ, コク+カ -> コッカ
    if len(prev) >= 2 and prev[-1] == "ク" and head in "カキクケコ":
        return prev[:-1] + "ッ", nxt
    # post-nasal h->p: ラン+ハク -> ランパク, ナン+フン -> ナンプン
    if prev[-1] == "ン" and head in _P_ROW and nxt not in _NP_KEEP:
        return prev, _P_ROW[head] + nxt[1:]
    return prev, nxt
_KATA_RX = re.compile(r"[ァ-ヶー]+")
_NUM_RX = re.compile(r"[0-9]+")
_ASCII_RX = re.compile(r"[A-Za-z]+")
_KANJI_RX = re.compile(r"[一-龯々〇]+")

# Compound keys bucketed by first char, longest first, so the scanner
# tries only plausible matches at each position.
_BY_FIRST: dict = {}
for _surface, _reading in COMPOUNDS.items():
    _BY_FIRST.setdefault(_surface[0], []).append((_surface, _reading))
for _lst in _BY_FIRST.values():
    _lst.sort(key=lambda kv: -len(kv[0]))


class LexiconReader:
    """Dictionary-free segmentation with embedded readings.

    Policy (tables in ``readings.py``): longest-match ``COMPOUNDS``
    first at every position; an unmatched single kanji — standing alone
    or followed by okurigana — takes its ``KUN`` reading; unmatched
    kanji inside a multi-kanji run take ``ON`` (the dominant jukugo
    reading). Kana passes through; a lone は between tokens is the
    topic particle (ワ). Unknown tokens pass through unchanged, as the
    reference does for words MeCab cannot read."""

    _FULLWIDTH = str.maketrans(
        "０１２３４５６７８９ＡＢＣＤＥＦＧＨＩＪＫＬＭＮＯＰＱＲＳＴＵＶＷＸＹＺ"
        "ａｂｃｄｅｆｇｈｉｊｋｌｍｎｏｐｑｒｓｔｕｖｗｘｙｚ",
        "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "abcdefghijklmnopqrstuvwxyz",
    )

    def tokens(self, text: str) -> List[Tuple[str, str]]:
        text = text.translate(self._FULLWIDTH)
        out: List[Tuple[str, str]] = []
        i = 0
        n = len(text)
        while i < n:
            # kanji runs FIRST: compounds are matched inside the run
            # scanner so a leading compound cannot strand the run's
            # last kanji as a false isolated-kun (物理+学, 二時+間)
            m = _KANJI_RX.match(text, i)
            if m:
                i = self._kanji_run(text, i, m.end(), out)
                continue
            surface_reading = self._match_compound(text, i)
            if surface_reading is not None:
                out.append(surface_reading)
                i += len(surface_reading[0])
                continue
            ch = text[i]
            m = _HIRA_RX.match(text, i)
            if m:
                run = m.group(0)
                if run == "へ":
                    # a lone へ between non-hiragana is the directional
                    # particle, pronounced エ
                    yomi = "エ"
                elif run == "は":
                    # a lone は between non-hiragana is the topic
                    # particle regardless of what precedes (brackets,
                    # symbols): ワ
                    yomi = "ワ"
                elif run.startswith("は") and out and out[-1][1]:
                    # は opening a hiragana run right after a read word
                    # is (almost always) the topic particle: ワ
                    yomi = "ワ" + hira2kata(run[1:])
                elif (
                    run.startswith("へ") and out and out[-1][1]
                    and (len(run) == 1 or run[1] in "のはもと")
                ):
                    # へ opening a run after a read word is the
                    # directional particle when a particle continuation
                    # follows (問題への, 駅へは, 海へと); content words
                    # like へた/へや are excluded by the continuation set
                    yomi = "エ" + hira2kata(run[1:])
                    if len(run) >= 2 and run[1] == "は":
                        yomi = "エワ" + hira2kata(run[2:])
                elif len(run) >= 2 and run.endswith("は"):
                    # ... as is a run-final は before kanji/punctuation
                    # (子供たちは公園で, それでは。)
                    yomi = hira2kata(run[:-1]) + "ワ"
                else:
                    yomi = hira2kata(run)
                # a particle は/へ directly after a run-INITIAL
                # demonstrative/pronoun reads ワ/エ even mid-run
                # (こちらへどうぞ, これはいい); それでは etc. keep the
                # run-final rules above (で precedes the は there)
                for dem in _DEMONSTRATIVES:
                    k = len(dem)
                    if run.startswith(dem) and k < len(run) \
                            and run[k] in "はへ":
                        rep = "ワ" if run[k] == "は" else "エ"
                        yomi = yomi[:k] + rep + yomi[k + 1:]
                        break
                # は directly after て/で is the topic particle even
                # mid-run (走ってはいけません, それではまた,
                # 食べてはだめ) — round-5 J9 sweep; after the
                # nominalizer の it is too (割り込むのはやめましょう),
                # except before ず/な/し where のは opens a noun
                # (そのはず, 野のはな, のはなし) — round-5 J21
                for j in range(1, len(run)):
                    if run[j] == "は" and (
                        run[j - 1] in "てで"
                        or (run[j - 1] == "の"
                            and run[j + 1:j + 2] not in ("ず", "な", "し"))
                    ):
                        yomi = yomi[:j] + "ワ" + yomi[j + 1:]
                out.append((run, yomi))
                i = m.end()
                continue
            m = _KATA_RX.match(text, i)
            if m:
                kata = m.group(0)
                # a numeral directly before a katakana loan geminates
                # like a counter (二十パーセント=ニジュッパーセント,
                # 十キロ=ジュッキロ, 八ページ=ハッページ); ハ行 loans
                # are excluded (十ヘクタール keeps ジュウ) — round-5
                # J27
                if out and out[-1][1]:
                    p_surf, p_yomi = out[-1]
                    numeric = all(c.isdigit() or c in "一二三四五六七八九十百千万〇"
                                  for c in p_surf)
                    head = kata[0]
                    if numeric and head in "カキクケコサシスセソタチツテトパピプペポ":
                        if p_yomi.endswith(("イチ", "ハチ", "ジュウ")):
                            out[-1] = (p_surf, p_yomi[:-1] + "ッ")
                        elif p_yomi.endswith("ロク") and head in "カキクケコパピプペポ":
                            out[-1] = (p_surf, p_yomi[:-1] + "ッ")
                out.append((kata, kata))
                i = m.end()
                continue
            m = _NUM_RX.match(text, i)
            if m:
                digits = m.group(0)
                j = m.end()
                # digit + counter kanji (2026年, 3時, 30分); compounds
                # at the counter split after it when counter-initial
                # (4年前 = ヨネン+マエ) via _emit_counter
                if j < n and text[j] in COUNTERS and digits.isdigit():
                    consumed = self._emit_counter(
                        text, i, j - i, int(digits), out)
                    if consumed:
                        i += consumed
                        continue
                out.append((digits, read_number(digits)))
                i = j
                continue
            m = _ASCII_RX.match(text, i)
            if m:
                out.append((m.group(0), ""))  # no reading: pass through
                i = m.end()
                continue
            out.append((ch, ""))
            i += 1
        return out

    @staticmethod
    def _match_compound(text: str, i: int):
        for surface, reading in _BY_FIRST.get(text[i], ()):
            if text.startswith(surface, i):
                return surface, reading
        return None

    def _emit_counter(self, text: str, pos: int, span: int, val,
                      out: List[Tuple[str, str]]) -> int:
        """Emit kanji-numeral + counter readings into ``out``; returns
        the number of characters consumed (0 = branch doesn't apply).

        A compound starting at the counter kanji splits after the
        counter when its reading begins with the counter's own
        (四年前 = ヨネン + マエ, 三時間 = サンジ + カン); otherwise it
        blocks the counter branch and the normal compound path runs.
        The ordinal suffix 目 directly after a counter reads メ
        (三回目 = サンカイメ, jukugo ON would give モク)."""
        if val is None:
            return 0
        counter = text[pos + span]
        reading = read_with_counter(str(val), counter)
        if reading is None:
            return 0
        hit = self._match_compound(text, pos + span)
        if hit is not None:
            cr = counter_reading(counter)
            if not (cr and len(hit[0]) > 1 and hit[1].startswith(cr)):
                return 0
            out.append((text[pos:pos + span + 1], reading))
            out.append((hit[0][1:], hit[1][len(cr):]))
            consumed = span + len(hit[0])
        else:
            out.append((text[pos:pos + span + 1], reading))
            consumed = span + 1
        j = pos + consumed
        if j < len(text) and text[j] == "目":
            out.append(("目", "メ"))
            consumed += 1
        return consumed

    def _kanji_run(self, text: str, i: int, end: int,
                   out: List[Tuple[str, str]]) -> int:
        """Consume one maximal kanji run starting at ``i`` (regex end
        ``end``) with compound-first, then KUN (isolated /
        okurigana-final) or ON (inside-run). Compounds with kana tails
        (一つ, 気に入り) may extend past ``end``; the returned cursor
        reflects that."""
        run_len = end - i
        pos = i
        seg_start = i  # start of the per-kanji segment (resets after
        # each compound hit: the kanji after 明日 in 明日返します is a
        # fresh word, not the tail of a jukugo)
        prev_on = -1  # index in out of the preceding on-read kanji
        while pos < end:
            # numeric counter 分: 三十分 = サンジュップン (the generic
            # 十分 compound reads the adverb ジュウブン)
            if (
                text.startswith("十分", pos)
                and ((pos > i and text[pos - 1] in "一二三四五六七八九")
                     or any(text.startswith(sfx, pos + 2)
                            for sfx in ("ほど", "間", "くらい",
                                        "ぐらい", "後", "前")))
            ):
                out.append(("十分", "ジュップン"))
                pos += 2
                seg_start = pos
                prev_on = -1
                continue
            hit = self._match_compound(text, pos)
            if hit is not None:
                if hit[0] == "一日" and out and out[-1][0].endswith("月"):
                    # a day-of-month after a month reads ツイタチ
                    # (四月一日); the generic compound keeps イチニチ
                    # ("one day") elsewhere — round-5 J23
                    hit = ("一日", "ツイタチ")
                elif hit[0] == "気味" and pos > i:
                    # the ~気味 suffix voices after a noun in the same
                    # run (風邪気味=カゼギミ); standalone 気味 keeps
                    # キミ (いい気味) — round-5 J29
                    hit = ("気味", "ギミ")
                out.append(hit)
                pos += len(hit[0])
                seg_start = pos
                prev_on = -1
                continue
            # numeral + か/ヶ infix + counter kanji (三か国=サンカコク,
            # 三ヶ月=サンカゲツ, 五か所=ゴカショ): read the numeral as
            # a Sino number, カ for the infix, and let the counter
            # kanji rejoin the next run — round-5 J18
            span = kanji_numeral_span(text, pos)
            _KA_COUNTERS = {"国": "コク", "所": "ショ", "月": "ゲツ",
                            "年": "ネン", "条": "ジョウ", "社": "シャ"}
            if (
                span and pos + span == end
                and end < len(text) and text[end] in "かヶケ"
                and text[end + 1: end + 2] in _KA_COUNTERS
            ):
                val = kanji_numeral_to_int(text[pos:pos + span])
                if val is not None:
                    out.append((text[pos:pos + span], read_number(str(val))))
                    out.append((text[end], "カ"))
                    nxt = _KANJI_RX.match(text, end + 1)
                    if nxt is not None and nxt.end() == end + 2:
                        # isolated counter kanji would take its kun
                        # (月=ツキ); pin the Sino reading here
                        out.append((text[end + 1],
                                    _KA_COUNTERS[text[end + 1]]))
                        return end + 2
                    # longer run (三か国語): the run scanner reads the
                    # jukugo with the counter in ON position
                    return end + 1
            # kanji numeral(s) + counter kanji read via the counter
            # paradigms (三十五度=サンジュウゴド, 九時=クジ), like their
            # ASCII-digit twins; bare 十分 stays with the earlier
            # special case / ジュウブン compound (adverb default)
            if (
                span and pos + span < end
                and text[pos + span] in COUNTERS
                and not (text[pos + span] == "分"
                         and text[pos:pos + span] == "十")
            ):
                val = kanji_numeral_to_int(text[pos:pos + span])
                consumed = self._emit_counter(text, pos, span, val, out)
                if consumed:
                    pos += consumed
                    seg_start = pos
                    prev_on = -1
                    continue
            ch = text[pos]
            if (
                ch == "目" and pos - 2 >= i
                and text[pos - 1] in COUNTERS
                and (text[pos - 2].isdigit()
                     or kanji_numeral_span(text, pos - 2))
            ):
                # ordinal 目 after numeral+counter reads メ even when
                # the pair came via a compound (三日目 = ミッカ+メ);
                # counter+目 jukugo without a numeral keep ON (名目)
                out.append((ch, "メ"))
                pos += 1
                seg_start = pos
                prev_on = -1
                continue
            if ch == "々" and out and out[-1][1]:
                # iteration mark: repeat the previous reading with the
                # common voicing left alone (人々 is in COMPOUNDS)
                out.append((ch, out[-1][1]))
                pos += 1
                prev_on = -1
                continue
            # a kanji right before the iteration mark reads as if
            # isolated (kun-first): 山々=ヤマヤマ, 木々=キギ — jukugo
            # ON would give サンサン
            before_iter = pos + 1 < end and text[pos + 1] == "々"
            # a run-final kanji right before hiragana is a verb/adj stem
            # with okurigana (kun) — unless that hiragana opens a
            # particle/copula, which marks the run as a jukugo noun;
            # inside a jukugo run it's on
            okurigana = (
                pos == end - 1
                and _HIRA_RX.match(text, end) is not None
                and text[end] not in _PARTICLE_HEADS
                and text[end:end + 2] not in _PARTICLE_PAIRS
                # a multi-kanji run after the honorific prefix ご is a
                # Sino noun (ご利用いただき = リヨウ, ご案内 = アンナイ)
                # even when keigo auxiliaries follow in hiragana
                and not (pos > seg_start and i > 0 and text[i - 1] == "ご")
                # a multi-kanji segment before し/さ/せ is almost
                # always a suru-noun (発表します, 調査され, 開催せず),
                # one before な a na-adjective (深刻な), and one before
                # する/すれ a plain suru-verb (印刷する): the final
                # kanji stays ON. Segment-initial kanji keep kun
                # (話します; 明日返します after the 明日 compound), and
                # a bare す okurigana (見直す) is untouched because it
                # is not followed by る/れ.
                and not (pos > seg_start and text[end] in "しさせな")
                and not (pos > seg_start and text[end] == "す"
                         and text[end + 1: end + 2] in ("る", "れ"))
                # keigo auxiliaries いたします/いただき after a
                # multi-kanji noun likewise mark it a jukugo
                # (調整いたします = チョウセイ) — round-5 J28
                and not (pos > seg_start
                         and text[end:end + 3] in ("いたし", "いただ"))
            )
            isolated = run_len == 1 or okurigana or before_iter
            # the pronoun 何 opens its own word even mid-run
            # (最近何か = ナニカ); its ナンで/ナンだ copula forms come
            # from KUN_OKURI, and the rare 何-final jukugo (幾何) are
            # compounds — round-5 J34
            if ch == "何" and pos == seg_start:
                isolated = True
            if (
                isolated and pos == end - 1 and end < len(text)
                and _KATA_RX.match(text, end) is not None
                and ch in _ON_PREFIX_KANJI
            ):
                # numeral/prefix kanji before a katakana loan reads ON
                # (一パック=イッ after the loan-gemination pass,
                # 新サービス=シン), unlike a standalone
                # noun (犬カフェ keeps kun)
                isolated = False
            if isolated:
                yomi = self._kun(text, ch, end, pos) or ON.get(ch) or ""
                on_read = not KUN.get(ch) and bool(ON.get(ch))
            else:
                yomi = ON.get(ch) or KUN.get(ch) or ""
                on_read = bool(ON.get(ch))
                # suffix rendaku: 版 as the third-or-later kanji of a
                # segment is the ~版 suffix and voices (訂正版=バン,
                # 最新版); word-second 版 keeps ハン (出版, 初版) —
                # round-5 J28
                if ch == "版" and pos - seg_start >= 2 and yomi == "ハン":
                    yomi = "バン"
            if on_read and prev_on >= 0 and yomi:
                p_surf, p_yomi = out[prev_on]
                p_yomi, yomi = _euphonic_join(
                    p_yomi, yomi,
                    even_boundary=((pos - 1 - seg_start) % 2 == 0))
                out[prev_on] = (p_surf, p_yomi)
            out.append((ch, yomi))
            prev_on = len(out) - 1 if on_read and yomi else -1
            pos += 1
        return max(pos, end)

    @staticmethod
    def _kun(text: str, ch: str, okuri_pos: int,
             kanji_pos: int = -1) -> str:
        """Kun reading for an isolated/stem kanji, selected by the
        okurigana that follows when the kanji has several kun stems
        (開ける=ア vs 開く=ヒラ, 入れる=イ vs 入る=ハイ,
        遅れる=オク vs 遅い=オソ). A 3-tuple variant additionally
        requires the char before the kanji to be in the given set
        (を通って=トオ vs に通って=カヨ)."""
        variants = KUN_OKURI.get(ch)
        if variants:
            prev = text[kanji_pos - 1] if kanji_pos > 0 else ""
            for variant in variants:
                okuri, reading = variant[0], variant[1]
                if not text.startswith(okuri, okuri_pos):
                    continue
                if len(variant) > 2:
                    cond = variant[2]
                    if cond.startswith("*"):
                        # clause-scan: the governing particle may be
                        # separated from the verb by adverbs (雪が
                        # たくさん降ります); scan back to the nearest
                        # case particle and test that instead. A "**"
                        # prefix additionally skips the adjunct
                        # particles に/で so a time/place phrase does
                        # not mask the object (会を金曜日に開きます
                        # still sees the を)
                        skip_adjuncts = cond.startswith("**")
                        stops = ("がをもはへ、。．！？　 "
                                 if skip_adjuncts
                                 else "がをにもはへで、。．！？　 ")
                        found = ""
                        for j in range(kanji_pos - 1, -1, -1):
                            # から/まで are clause stops too: バスから
                            # 降ります must not scan past ら to a
                            # distant subject が (ら alone is not a
                            # particle, so match the two-char form)
                            if text[j] in "らで" and j > 0 and (
                                text[j - 1: j + 1] in ("から", "まで")
                            ):
                                found = text[j - 1: j + 1]
                                break
                            if text[j] in stops:
                                found = text[j]
                                break
                        # no governing particle found: reject the
                        # conditioned variant (降ります sentence-initial
                        # reads オリマス — the get-off sense)
                        if not found or found not in cond[1:]:
                            continue
                    elif prev not in cond:
                        continue
                return reading
        return KUN.get(ch, "")


class MecabReader:
    """MeCab-backed reader, equivalent to the reference tagger usage."""

    def __init__(self) -> None:
        import fugashi  # type: ignore

        self._tagger = fugashi.Tagger()

    def tokens(self, text: str) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for line in self._tagger.parse(text).split("\n"):
            if line == "EOS":
                break
            parts = line.split("\t")
            word = parts[0]
            yomi = parts[1] if len(parts) > 1 else ""
            out.append((word, yomi))
        return out


def _make_reader():
    try:
        return MecabReader()
    except Exception:
        return LexiconReader()


_READER = None


def text2kata(text: str) -> str:
    """Japanese text -> katakana string.

    Token policy mirrors voice100/japanese/phonemizer.py:360-380: use the
    reading when available; symbols and small-tsu pass through; bracket
    tokens are dropped; unreadable words pass through unchanged.
    """
    global _READER
    if _READER is None:
        _READER = _make_reader()
    res: List[str] = []
    for word, yomi in _READER.tokens(text):
        if yomi:
            res.append(yomi)
        elif word in _SYMBOL_TOKENS:
            res.append(word)
        elif word in ("っ", "ッ"):
            res.append("ッ")
        elif word in _NO_YOMI_TOKENS:
            pass
        else:
            res.append(word)
    return hira2kata("".join(res))
