"""Context-rule heteronym (homograph) disambiguation for English G2P.

The reference pipeline inherits homograph handling from g2p_en
(voice100/text.py:64-71): g2p_en tags the sentence with a perceptron POS
tagger and picks between two dictionary pronunciations per homograph
(its homographs.en table). This module provides the hermetic
equivalent: a table of common heteronyms with noun/verb/adjective
pronunciations and a lightweight cue-word tagger that decides from the
immediately neighbouring tokens. Unambiguous inflections (-ed / -ing
verb forms of stress-pair heteronyms, e.g. "recorded") are exported as
plain lexicon entries.

Slots per entry: (noun, verb, adj-or-None, default tag). A missing adj
slot falls back to the noun slot; the default tag is used when no
contextual cue fires, and is chosen so that a word in isolation keeps
the pronunciation the gold lexicon already pins.
"""

from typing import Dict, List, Optional, Tuple

# word -> (noun pron, verb pron, adj pron or None, default tag)
_BASE: Dict[str, Tuple[str, str, Optional[str], str]] = {
    # noun/verb stress pairs (noun: initial stress, verb: final stress)
    "record": ("R EH1 K ER0 D", "R IH0 K AO1 R D", None, "N"),
    "present": ("P R EH1 Z AH0 N T", "P R IY0 Z EH1 N T", None, "N"),
    "object": ("AA1 B JH EH0 K T", "AH0 B JH EH1 K T", None, "N"),
    "permit": ("P ER1 M IH0 T", "P ER0 M IH1 T", None, "V"),
    "subject": ("S AH1 B JH IH0 K T", "S AH0 B JH EH1 K T", None, "N"),
    "conduct": ("K AA1 N D AH0 K T", "K AH0 N D AH1 K T", None, "N"),
    "contract": ("K AA1 N T R AE2 K T", "K AH0 N T R AE1 K T", None, "N"),
    "content": ("K AA1 N T EH0 N T", "K AH0 N T EH1 N T",
                "K AH0 N T EH1 N T", "N"),
    "desert": ("D EH1 Z ER0 T", "D IH0 Z ER1 T", None, "N"),
    "insult": ("IH1 N S AH0 L T", "IH0 N S AH1 L T", None, "N"),
    "increase": ("IH1 N K R IY2 S", "IH0 N K R IY1 S", None, "N"),
    "decrease": ("D IH1 K R IY2 S", "D IH0 K R IY1 S", None, "N"),
    "protest": ("P R OW1 T EH2 S T", "P R AH0 T EH1 S T", None, "N"),
    "suspect": ("S AH1 S P EH2 K T", "S AH0 S P EH1 K T", None, "N"),
    "survey": ("S ER1 V EY2", "S ER0 V EY1", None, "N"),
    "import": ("IH1 M P AO2 R T", "IH0 M P AO1 R T", None, "N"),
    "export": ("EH1 K S P AO2 R T", "IH0 K S P AO1 R T", None, "N"),
    "extract": ("EH1 K S T R AE2 K T", "IH0 K S T R AE1 K T", None, "N"),
    "impact": ("IH1 M P AE0 K T", "IH0 M P AE1 K T", None, "N"),
    "insert": ("IH1 N S ER2 T", "IH0 N S ER1 T", None, "V"),
    "convert": ("K AA1 N V ER0 T", "K AH0 N V ER1 T", None, "V"),
    "convict": ("K AA1 N V IH0 K T", "K AH0 N V IH1 K T", None, "V"),
    "contest": ("K AA1 N T EH0 S T", "K AH0 N T EH1 S T", None, "N"),
    "conflict": ("K AA1 N F L IH0 K T", "K AH0 N F L IH1 K T", None, "N"),
    "compound": ("K AA1 M P AW0 N D", "K AH0 M P AW1 N D", None, "N"),
    "digest": ("D AY1 JH EH0 S T", "D AY0 JH EH1 S T", None, "V"),
    "progress": ("P R AA1 G R EH2 S", "P R AH0 G R EH1 S", None, "N"),
    "rebel": ("R EH1 B AH0 L", "R IH0 B EH1 L", None, "N"),
    "refund": ("R IY1 F AH2 N D", "R IH0 F AH1 N D", None, "N"),
    "refuse": ("R EH1 F Y UW2 S", "R IH0 F Y UW1 Z", None, "V"),
    "upset": ("AH1 P S EH2 T", "AH0 P S EH1 T", "AH0 P S EH1 T", "V"),
    "address": ("AE1 D R EH2 S", "AH0 D R EH1 S", None, "V"),
    "attribute": ("AE1 T R IH0 B Y UW2 T", "AH0 T R IH1 B Y UW0 T",
                  None, "N"),
    "perfume": ("P ER1 F Y UW2 M", "P ER0 F Y UW1 M", None, "N"),
    "produce": ("P R OW1 D UW0 S", "P R AH0 D UW1 S", None, "V"),
    "project": ("P R AA1 JH EH0 K T", "P R AH0 JH EH1 K T", None, "N"),
    "transport": ("T R AE1 N S P AO2 R T", "T R AE0 N S P AO1 R T",
                  None, "N"),
    "transfer": ("T R AE1 N S F ER0", "T R AE0 N S F ER1", None, "N"),
    "escort": ("EH1 S K AO0 R T", "EH0 S K AO1 R T", None, "N"),
    "incline": ("IH1 N K L AY0 N", "IH0 N K L AY1 N", None, "V"),
    "pervert": ("P ER1 V ER0 T", "P ER0 V ER1 T", None, "N"),
    "exploit": ("EH1 K S P L OY2 T", "EH0 K S P L OY1 T", None, "V"),
    "recall": ("R IY1 K AO2 L", "R IH0 K AO1 L", None, "V"),
    "reject": ("R IY1 JH EH0 K T", "R IH0 JH EH1 K T", None, "V"),
    # -ate words: noun/adjective AH0 T vs verb EY2 T
    "separate": ("S EH1 P ER0 AH0 T", "S EH1 P ER0 EY2 T", None, "N"),
    "graduate": ("G R AE1 JH AH0 W AH0 T", "G R AE1 JH AH0 W EY2 T",
                 None, "N"),
    "estimate": ("EH1 S T AH0 M AH0 T", "EH1 S T AH0 M EY2 T", None, "N"),
    "moderate": ("M AA1 D ER0 AH0 T", "M AA1 D ER0 EY2 T", None, "N"),
    "alternate": ("AO1 L T ER0 N AH0 T", "AO1 L T ER0 N EY2 T", None, "N"),
    "deliberate": ("D IH0 L IH1 B ER0 AH0 T", "D IH0 L IH1 B ER0 EY2 T",
                   None, "N"),
    "associate": ("AH0 S OW1 S IY0 AH0 T", "AH0 S OW1 S IY0 EY2 T",
                  None, "N"),
    "duplicate": ("D UW1 P L AH0 K AH0 T", "D UW1 P L AH0 K EY2 T",
                  None, "N"),
    "delegate": ("D EH1 L AH0 G AH0 T", "D EH1 L AH0 G EY2 T", None, "N"),
    "advocate": ("AE1 D V AH0 K AH0 T", "AE1 D V AH0 K EY2 T", None, "N"),
    # final-consonant voicing pairs (noun S vs verb Z)
    "use": ("Y UW1 S", "Y UW1 Z", None, "N"),
    "excuse": ("IH0 K S K Y UW1 S", "IH0 K S K Y UW1 Z", None, "V"),
    "abuse": ("AH0 B Y UW1 S", "AH0 B Y UW1 Z", None, "N"),
    "house": ("HH AW1 S", "HH AW1 Z", None, "N"),
    "close": ("K L OW1 S", "K L OW1 Z", "K L OW1 S", "V"),
    # vowel-quality pairs
    "live": ("L AY1 V", "L IH1 V", "L AY1 V", "V"),
    "lives": ("L AY1 V Z", "L IH1 V Z", None, "V"),
    "wind": ("W IH1 N D", "W AY1 N D", None, "N"),
    "wound": ("W UW1 N D", "W AW1 N D", None, "N"),
    "bow": ("B OW1", "B AW1", None, "N"),
    "sow": ("S AW1", "S OW1", None, "V"),
    # "invalid" the noun (= sick person) is archaic; always the adjective
    "invalid": ("IH0 N V AE1 L AH0 D", "IH0 N V AE1 L AH0 D",
                "IH0 N V AE1 L AH0 D", "ADJ"),
    # "read": present vs past handled by a dedicated cue set below
    "read": ("R IY1 D", "R IY1 D", None, "V"),
}

# cue sets for the one-token tagger
_DETS = frozenset(
    "the a an this that these those my your his her its our their no "
    "every each some any another such whose".split())
_PREPS = frozenset(
    "of in on at for with without from by about over under during "
    "after before into through against between behind near".split())
_TO_MODALS = frozenset(
    "to will would can could may might must shall should do does did "
    "don't doesn't didn't won't wouldn't couldn't shouldn't can't "
    "cannot let let's please not never gonna".split())

_PRONOUNS = frozenset(
    "i you he she it we they who people children police".split())
# adverbs the cue walk may cross ("not"/"never" are also verb cues:
# they fire as cues for plain heteronyms but let the "read" past-tense
# walk continue to the auxiliary: "have never read")
_TRANSPARENT = frozenset(
    "also just still then now often usually always quickly really "
    "soon carefully finally simply even again only not never".split())
_CONJS = frozenset({"and", "or"})
# common transitive past forms: after "<verb> <noun> and <heteronym>"
# the heteronym is a coordinated object, hence a noun
_PAST_VERBS = frozenset(
    "bought sold saw got had made took gave found kept sent built "
    "brought held lost won wrote read ate".split())
_BE_ADVS = frozenset(
    "is are was were am be been being seems seemed looks looked very "
    "quite too so really pretty fairly rather how as more most".split())

# perfect/passive cues that flip "read" to its past pronunciation
_READ_PAST_CUES = frozenset(
    "have has had was were been already i've you've we've they've "
    "he's she's".split())

_SIBILANTS = frozenset({"S", "Z", "SH", "ZH", "CH", "JH"})
_VOICELESS = frozenset({"P", "T", "K", "F", "TH"})


def _plural(pron: str) -> str:
    phones = pron.split()
    last = phones[-1].rstrip("012")
    if last in _SIBILANTS:
        phones += ["IH0", "Z"]
    elif last in _VOICELESS:
        phones.append("S")
    else:
        phones.append("Z")
    return " ".join(phones)


def _past(pron: str) -> str:
    phones = pron.split()
    last = phones[-1].rstrip("012")
    if last in ("T", "D"):
        phones += ["IH0", "D"]
    elif last in _VOICELESS or last in ("S", "SH", "CH"):
        phones.append("T")
    else:
        phones.append("D")
    return " ".join(phones)


def _build_table() -> Dict[str, Tuple[str, str, Optional[str], str]]:
    """Base entries plus -s forms (context-dependent like the base)."""
    table = dict(_BASE)
    skip_s = {"read", "lives", "close", "house", "bow", "sow", "wound",
              "invalid", "upset", "deliberate", "separate", "moderate",
              "alternate", "content"}
    for word, (noun, verb, adj, default) in _BASE.items():
        if word in skip_s:
            continue
        spelled = word + ("es" if word.endswith(("s", "sh", "ch", "x"))
                          else "s")
        if spelled in table:
            continue
        table[spelled] = (
            _plural(noun), _plural(verb),
            _plural(adj) if adj else None, default)
    return table


TABLE = _build_table()

# irregular / non-productive -ed spellings; None = no regular past form
_ED_OVERRIDES: Dict[str, Optional[str]] = {
    "read": None, "wind": None, "upset": None, "lives": None,
    "permit": "permitted", "rebel": "rebelled", "transfer": "transferred",
    "refer": "referred",
}
_ING_OVERRIDES: Dict[str, str] = {
    "permit": "permitting", "rebel": "rebelling",
    "transfer": "transferring", "upset": "upsetting",
}


def verb_forms() -> Dict[str, str]:
    """Unambiguous -ed / -ing verb inflections of the heteronyms,
    pronounced with the verb-slot stress/voicing (e.g. "recorded" ->
    R IH0 K AO1 R D IH0 D). Merged into the G2P lexicon so they no
    longer fall through to letter-to-sound."""
    forms: Dict[str, str] = {}
    for word, (_, verb, _, _) in _BASE.items():
        if word in ("lives", "read", "wound"):
            continue
        stem = word[:-1] if word.endswith("e") else word
        ed = _ED_OVERRIDES.get(word, stem + "ed")
        if ed:
            forms[ed] = _past(verb)
        ing = _ING_OVERRIDES.get(word, stem + "ing")
        forms[ing] = verb + " IH0 NG"
    return forms


def _is_word(tok: Optional[str]) -> bool:
    return bool(tok) and (tok[0].isalpha() or tok[0] == "'")


def _cue_tag(words: List[str], i: int,
             depth: int = 0) -> Optional[str]:
    """Walk left from ``i`` for a function-word cue, crossing
    transparent adverbs; after a conjunction, keep walking toward the
    clause opener (a coordinated TABLE sibling donates its tag, a plain
    past verb marks us as its object)."""
    j = i - 1
    hops = 0
    crossed_conj = False
    while j >= 0 and hops < 6:
        tok = words[j]
        if not _is_word(tok):
            return None  # punctuation = clause boundary
        if tok in _TO_MODALS or tok in _PRONOUNS:
            return "V"
        if tok in _BE_ADVS:
            return "ADJ"
        if tok in _DETS or tok in _PREPS:
            return "N"
        if tok in _CONJS:
            crossed_conj = True
        elif tok not in _TRANSPARENT:
            if not crossed_conj:
                return None
            if tok in TABLE and depth == 0:
                return _cue_tag(words, j, depth=1)
            if tok.endswith("ed") or tok in _PAST_VERBS:
                return "N"
        j -= 1
        hops += 1
    return None


def resolve(word: str, words: List[str], i: int) -> Optional[List[str]]:
    """Pick a pronunciation for ``words[i]`` from sentence context
    (lowercase token list). Returns None for non-heteronyms."""
    entry = TABLE.get(word)
    if entry is None:
        return None
    noun, verb, adj, default = entry
    if word == "read":
        j = i - 1
        while j >= 0 and _is_word(words[j]):
            tok = words[j]
            if tok in _READ_PAST_CUES:
                return ["R", "EH1", "D"]
            if tok not in _TRANSPARENT:
                break
            j -= 1
        return ["R", "IY1", "D"]
    nxt = words[i + 1] if i + 1 < len(words) else None
    tag: Optional[str] = None
    if word == "close" and nxt == "to":
        tag = "ADJ"
    elif word in ("wind", "winds") and nxt in ("up", "down"):
        # verb-particle reading: "wind up the kite string" = W AY1 N D
        tag = "V"
    else:
        tag = _cue_tag(words, i)
    if tag is None:
        # bare plural/collective subject opening the clause reads the
        # heteronym as its verb: "students graduate", "prices increase"
        prev = words[i - 1] if i > 0 else None
        prev2 = words[i - 2] if i > 1 else None
        if (_is_word(prev) and prev.endswith("s") and prev not in TABLE
                and prev not in _TRANSPARENT
                and (prev2 is None or not _is_word(prev2))):
            tag = "V"
    if tag is None:
        tag = default
    if tag == "ADJ":
        pron = adj or noun
    elif tag == "V":
        pron = verb
    else:
        pron = noun
    return pron.split()
