"""English grapheme-to-phoneme (CMU phone set).

The reference delegates English G2P to the ``g2p_en`` package
(voice100/text.py:59-71), which combines a CMUdict lookup with a neural
fallback. This environment has neither the package nor the dictionary
data, so this module provides a self-contained replacement with the same
output contract (a list of CMU phone tokens, words separated by ``' '``
tokens, punctuation passed through):

1. an embedded exception lexicon of common words (accurate CMUdict
   pronunciations),
2. a deterministic rule-based letter-to-sound engine for everything else,
3. optional upgrades: an external CMUdict-format lexicon file
   (``G2P(lexicon_path=...)``) or the real ``g2p_en`` package when
   importable.

The fallback rules favor consistency over perfection; for production
phone-mode corpora, point ``lexicon_path`` at a full CMUdict.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

__all__ = ["G2P"]

# Accurate CMUdict pronunciations for frequent words (function words and
# words appearing in the project's demo texts / tests).
_LEXICON: Dict[str, str] = {
    # round-3 thirteenth probe: -ile split family (US: Latinate
    # adjectives reduce to AH0 L, nouns keep AY2 L), wh+ever stress,
    # indefinite-pronoun secondary stress, -ture irregulars
    "adventure": "AE0 D V EH1 N CH ER0",
    "agriculture": "AE1 G R IH0 K AH2 L CH ER0",
    "architecture": "AA1 R K AH0 T EH2 K CH ER0",
    "automobile": "AO1 T AH0 M OW0 B IY2 L",
    "mobile": "M OW1 B AH0 L", "profile": "P R OW1 F AY2 L",
    "reptile": "R EH1 P T AY2 L", "textile": "T EH1 K S T AY2 L",
    "percentile": "P ER0 S EH1 N T AY2 L",
    "missile": "M IH1 S AH0 L", "fragile": "F R AE1 JH AH0 L",
    "hostile": "HH AA1 S T AH0 L", "fertile": "F ER1 T AH0 L",
    "sterile": "S T EH1 R AH0 L", "futile": "F Y UW1 T AH0 L",
    "meanwhile": "M IY1 N W AY2 L", "nowhere": "N OW1 W EH2 R",
    "keyboard": "K IY1 B AO2 R D",
    "anybody": "EH1 N IY0 B AA2 D IY0", "anyone": "EH1 N IY0 W AH2 N",
    "anything": "EH1 N IY0 TH IH2 NG", "someone": "S AH1 M W AH2 N",
    "nobody": "N OW1 B AA2 D IY0",
    "whoever": "HH UW0 EH1 V ER0", "whenever": "W EH0 N EH1 V ER0",
    "whatever": "W AH2 T EH1 V ER0", "wherever": "W EH0 R EH1 V ER0",
    "whichever": "W IH0 CH EH1 V ER0",
    "acknowledge": "AE0 K N AA1 L IH0 JH",
    "privilege": "P R IH1 V L AH0 JH",
    "beverage": "B EH1 V ER0 IH0 JH",
    # round-3 fourteenth probe: tech/civic vocabulary
    "technology": "T EH0 K N AA1 L AH0 JH IY0",
    "photographer": "F AH0 T AA1 G R AH0 F ER0",
    "economy": "IH0 K AA1 N AH0 M IY0",
    "economic": "EH2 K AH0 N AA1 M IH0 K",
    "electronic": "IH0 L EH2 K T R AA1 N IH0 K",
    "software": "S AO1 F T W EH2 R", "hardware": "HH AA1 R D W EH2 R",
    "network": "N EH1 T W ER2 K", "email": "IY1 M EY2 L",
    "algorithm": "AE1 L G ER0 IH2 DH AH0 M", "data": "D EY1 T AH0",
    "environment": "IH0 N V AY1 R AH0 N M AH0 N T",
    "parliament": "P AA1 R L AH0 M AH0 N T",
    "president": "P R EH1 Z AH0 D AH0 N T",
    "election": "IH0 L EH1 K SH AH0 N",
    "politics": "P AA1 L AH0 T IH2 K S",
    "society": "S AH0 S AY1 AH0 T IY0",
    "education": "EH2 JH AH0 K EY1 SH AH0 N",
    "professor": "P R AH0 F EH1 S ER0",
    "percent": "P ER0 S EH1 N T",
    "insect": "IH1 N S EH2 K T", "beer": "B IH1 R",
    "razor": "R EY1 Z ER0",
    # irregular-verb band (seventeenth probe)
    "drove": "D R OW1 V", "forget": "F ER0 G EH1 T",
    "forgot": "F ER0 G AA1 T", "forgotten": "F ER0 G AA1 T AH0 N",
    "risen": "R IH1 Z AH0 N", "shaken": "SH EY1 K AH0 N",
    "worn": "W AO1 R N",
    # emotion/clothing band (eighteenth probe)
    "eyebrow": "AY1 B R AW2", "trousers": "T R AW1 Z ER0 Z",
    "windy": "W IH1 N D IY0", "ashamed": "AH0 SH EY1 M D",
    "embarrassed": "IH0 M B EH1 R AH0 S T",
    "disappointed": "D IH2 S AH0 P OY1 N T IH0 D",
    "grateful": "G R EY1 T F AH0 L", "polite": "P AH0 L AY1 T",
    "timid": "T IH1 M AH0 D", "arrogant": "EH1 R AH0 G AH0 N T",
    # place names (nineteenth probe)
    "asia": "EY1 ZH AH0", "tokyo": "T OW1 K IY0 OW2",
    "korea": "K ER0 IY1 AH0", "brazil": "B R AH0 Z IH1 L",
    "madrid": "M AH0 D R IH1 D", "moscow": "M AA1 S K AW2",
    "antarctica": "AE0 N T AA1 R K T IH0 K AH0",
    # communication/cooking band (twentieth probe)
    "explanation": "EH2 K S P L AH0 N EY1 SH AH0 N",
    "introduce": "IH2 N T R AH0 D UW1 S",
    "pronounce": "P R AH0 N AW1 N S",
    "pronunciation": "P R OW0 N AH2 N S IY0 EY1 SH AH0 N",
    "translate": "T R AE0 N S L EY1 T",
    "translation": "T R AE0 N S L EY1 SH AH0 N",
    "microwave": "M AY1 K R OW0 W EY2 V",
    "ingredient": "IH0 N G R IY1 D IY0 AH0 N T",
    "flavor": "F L EY1 V ER0", "supper": "S AH1 P ER0",
    # adverb/connective band (twenty-first probe)
    "nevertheless": "N EH2 V ER0 DH AH0 L EH1 S",
    "nonetheless": "N AH2 N DH AH0 L EH1 S",
    "therefore": "DH EH1 R F AO2 R", "unless": "AH0 N L EH1 S",
    "until": "AH0 N T IH1 L", "whilst": "W AY1 L S T",
    "whereas": "W EH0 R AE1 Z",
    "definitely": "D EH1 F AH0 N AH0 T L IY0",
    "obviously": "AA1 B V IY0 AH0 S L IY0",
    "fortunately": "F AO1 R CH AH0 N AH0 T L IY0",
    "unfortunately": "AH0 N F AO1 R CH AH0 N AH0 T L IY0",
    "immediately": "IH0 M IY1 D IY0 AH0 T L IY0",
    "eventually": "IH0 V EH1 N CH UW0 AH0 L IY0",
    "nearly": "N IH1 R L IY0",
    "entirely": "IH0 N T AY1 ER0 L IY0",
    "particularly": "P ER0 T IH1 K Y AH0 L ER0 L IY0",
    "sufficient": "S AH0 F IH1 SH AH0 N T",
    "generally": "JH EH1 N ER0 AH0 L IY0",
    # sports/music/arts band (twenty-second probe)
    "soccer": "S AA1 K ER0", "baseball": "B EY1 S B AO2 L",
    "violin": "V AY2 AH0 L IH1 N", "piano": "P IY0 AE1 N OW0",
    "concert": "K AA1 N S ER0 T", "composer": "K AH0 M P OW1 Z ER0",
    "gallery": "G AE1 L ER0 IY0", "landscape": "L AE1 N D S K EY2 P",
    "palette": "P AE1 L AH0 T", "trophy": "T R OW1 F IY0",
    "novel": "N AA1 V AH0 L", "escape": "IH0 S K EY1 P",
    # round-3 additions from out-of-gold generalization probes
    "achieve": "AH0 CH IY1 V", "arrange": "ER0 EY1 N JH",
    "borrow": "B AA1 R OW2", "celebrate": "S EH1 L AH0 B R EY2 T",
    "compare": "K AH0 M P EH1 R", "complain": "K AH0 M P L EY1 N",
    "decorate": "D EH1 K ER0 EY2 T", "deliver": "D IH0 L IH1 V ER0",
    "discover": "D IH0 S K AH1 V ER0", "encourage": "EH0 N K ER1 IH0 JH",
    "exercise": "EH1 K S ER0 S AY2 Z", "explain": "IH0 K S P L EY1 N",
    "imagine": "IH0 M AE1 JH AH0 N", "improve": "IH0 M P R UW1 V",
    "invite": "IH0 N V AY1 T", "organize": "AO1 R G AH0 N AY2 Z",
    "prepare": "P R IY0 P EH1 R", "pretend": "P R IY0 T EH1 N D",
    "protect": "P R AH0 T EH1 K T", "receive": "R AH0 S IY1 V",
    "recognize": "R EH1 K AH0 G N AY2 Z", "suppose": "S AH0 P OW1 Z",
    "curious": "K Y UH1 R IY0 AH0 S", "delicious": "D IH0 L IH1 SH AH0 S",
    "enormous": "IH0 N AO1 R M AH0 S", "expensive": "IH0 K S P EH1 N S IH0 V",
    "generous": "JH EH1 N ER0 AH0 S", "gorgeous": "G AO1 R JH AH0 S",
    "horrible": "HH AO1 R AH0 B AH0 L", "nervous": "N ER1 V AH0 S",
    "ordinary": "AO1 R D AH0 N EH2 R IY0", "precious": "P R EH1 SH AH0 S",
    "serious": "S IH1 R IY0 AH0 S", "terrible": "T EH1 R AH0 B AH0 L",
    "valuable": "V AE1 L Y AH0 B AH0 L", "hospital": "HH AA1 S P IH0 T AH0 L",
    "medicine": "M EH1 D AH0 S AH0 N", "doctor": "D AA1 K T ER0",
    "station": "S T EY1 SH AH0 N", "airport": "EH1 R P AO2 R T",
    "traffic": "T R AE1 F IH0 K", "bicycle": "B AY1 S IH0 K AH0 L",
    "market": "M AA1 R K AH0 T", "office": "AO1 F AH0 S",
    "factory": "F AE1 K T ER0 IY0", "salary": "S AE1 L ER0 IY0",
    "manager": "M AE1 N AH0 JH ER0", "physics": "F IH1 Z IH0 K S",
    "planet": "P L AE1 N AH0 T", "desert": "D EH1 Z ER0 T",
    "valley": "V AE1 L IY0", "bridge": "B R IH1 JH",
    "church": "CH ER1 CH", "temple": "T EH1 M P AH0 L",
    "museum": "M Y UW0 Z IY1 AH0 M", "hotel": "HH OW0 T EH1 L",
    "dinner": "D IH1 N ER0", "dessert": "D IH0 Z ER1 T",
    "coffee": "K AA1 F IY0", "chicken": "CH IH1 K AH0 N",
    "sausage": "S AO1 S IH0 JH", "furniture": "F ER1 N IH0 CH ER0",
    "ceiling": "S IY1 L IH0 NG", "garage": "G ER0 AA1 ZH",
    "mirror": "M IH1 R ER0", "soap": "S OW1 P",
    "shampoo": "SH AE0 M P UW1", "needle": "N IY1 D AH0 L",
    "button": "B AH1 T AH0 N", "pocket": "P AA1 K AH0 T",
    "universe": "Y UW1 N AH0 V ER2 S",
    "second": "S EH1 K AH0 N D", "third": "TH ER1 D",
    "fourth": "F AO1 R TH", "fifth": "F IH1 F TH",
    "sixth": "S IH1 K S TH", "seventh": "S EH1 V AH0 N TH",
    "ninth": "N AY1 N TH", "tenth": "T EH1 N TH",
    "eleventh": "IH0 L EH1 V AH0 N TH", "twelfth": "T W EH1 L F TH",
    "twentieth": "T W EH1 N T IY0 AH0 TH", "thirtieth": "TH ER1 T IY0 AH0 TH",
    "fortieth": "F AO1 R T IY0 AH0 TH", "fiftieth": "F IH1 F T IY0 AH0 TH",
    "sixtieth": "S IH1 K S T IY0 AH0 TH", "seventieth": "S EH1 V AH0 N T IY0 AH0 TH",
    "eightieth": "EY1 T IY0 AH0 TH", "ninetieth": "N AY1 N T IY0 AH0 TH",
    "hundredth": "HH AH1 N D R AH0 D TH", "thousandth": "TH AW1 Z AH0 N D TH",
    "millionth": "M IH1 L Y AH0 N TH", "dollar": "D AA1 L ER0",
    "dollars": "D AA1 L ER0 Z", "cent": "S EH1 N T",
    "cents": "S EH1 N T S", "pound": "P AW1 N D",
    "pounds": "P AW1 N D Z", "oh": "OW1",
    "january": "JH AE1 N Y UW0 EH2 R IY0", "april": "EY1 P R AH0 L",
    "july": "JH UW0 L AY1", "august": "AO1 G AH0 S T",
    "september": "S EH0 P T EH1 M B ER0", "october": "AA0 K T OW1 B ER0",
    "november": "N OW0 V EH1 M B ER0", "december": "D IH0 S EH1 M B ER0",
    "washington": "W AA1 SH IH0 NG T AH0 N", "london": "L AH1 N D AH0 N",
    "america": "AH0 M EH1 R AH0 K AH0", "american": "AH0 M EH1 R AH0 K AH0 N",
    "england": "IH1 NG G L AH0 N D", "english": "IH1 NG G L IH0 SH",
    "france": "F R AE1 N S", "japan": "JH AH0 P AE1 N",
    "japanese": "JH AE2 P AH0 N IY1 Z", "china": "CH AY1 N AH0",
    "chinese": "CH AY0 N IY1 Z", "india": "IH1 N D IY0 AH0",
    "germany": "JH ER1 M AH0 N IY0", "australia": "AO0 S T R EY1 L Y AH0",
    "africa": "AE1 F R IH0 K AH0", "mexico": "M EH1 K S AH0 K OW2",
    "canada": "K AE1 N AH0 D AH0", "russia": "R AH1 SH AH0",
    "italy": "IH1 T AH0 L IY0",
    "computer": "K AH0 M P Y UW1 T ER0", "internet": "IH1 N T ER0 N EH2 T",
    "morning": "M AO1 R N IH0 NG", "afternoon": "AE2 F T ER0 N UW1 N",
    "window": "W IH1 N D OW0", "building": "B IH1 L D IH0 NG",
    "important": "IH0 M P AO1 R T AH0 N T", "development": "D IH0 V EH1 L AH0 P M AH0 N T",
    "government": "G AH1 V ER0 M AH0 N T", "different": "D IH1 F ER0 AH0 N T",
    "possible": "P AA1 S AH0 B AH0 L", "together": "T AH0 G EH1 DH ER0",
    "remember": "R IH0 M EH1 M B ER0", "understand": "AH2 N D ER0 S T AE1 N D",
    "problem": "P R AA1 B L AH0 M", "question": "K W EH1 S CH AH0 N",
    "language": "L AE1 NG G W AH0 JH", "example": "IH0 G Z AE1 M P AH0 L",
    "student": "S T UW1 D AH0 N T", "teacher": "T IY1 CH ER0",
    "winter": "W IH1 N T ER0", "summer": "S AH1 M ER0",
    "tomorrow": "T AH0 M AA1 R OW2", "yesterday": "Y EH1 S T ER0 D EY2",
    "breakfast": "B R EH1 K F AH0 S T", "kitchen": "K IH1 CH AH0 N",
    "bedroom": "B EH1 D R UW2 M", "garden": "G AA1 R D AH0 N",
    "mountain": "M AW1 N T AH0 N", "river": "R IH1 V ER0",
    "forest": "F AO1 R AH0 S T", "animal": "AE1 N AH0 M AH0 L",
    "flower": "F L AW1 ER0", "spring": "S P R IH1 NG",
    "autumn": "AO1 T AH0 M", "weather": "W EH1 DH ER0",
    "nature": "N EY1 CH ER0", "picture": "P IH1 K CH ER0",
    "moment": "M OW1 M AH0 N T", "biology": "B AY0 AA1 L AH0 JH IY0",
    "geography": "JH IY0 AA1 G R AH0 F IY0", "photography": "F AH0 T AA1 G R AH0 F IY0",
    "photograph": "F OW1 T AH0 G R AE2 F", "celebration": "S EH2 L AH0 B R EY1 SH AH0 N",
    "competition": "K AA2 M P AH0 T IH1 SH AH0 N", "electricity": "IH0 L EH0 K T R IH1 S AH0 T IY0",
    "happier": "HH AE1 P IY0 ER0", "happiest": "HH AE1 P IY0 AH0 S T",
    "running": "R AH1 N IH0 NG", "stopped": "S T AA1 P T",
    "carried": "K AE1 R IY0 D", "carefully": "K EH1 R F AH0 L IY0",
    "national": "N AE1 SH AH0 N AH0 L", "international": "IH2 N T ER0 N AE1 SH AH0 N AH0 L",
    "organization": "AO2 R G AH0 N AH0 Z EY1 SH AH0 N", "communicate": "K AH0 M Y UW1 N AH0 K EY2 T",
    "communication": "K AH0 M Y UW2 N AH0 K EY1 SH AH0 N", "enjoyed": "EH0 N JH OY1 D",
    "watching": "W AA1 CH IH0 NG", "knives": "N AY1 V Z",
    "activities": "AE0 K T IH1 V AH0 T IY0 Z", "described": "D IH0 S K R AY1 B D",
    "surprising": "S ER0 P R AY1 Z IH0 NG", "dangerous": "D EY1 N JH ER0 AH0 S",
    "comfortable": "K AH1 M F ER0 T AH0 B AH0 L",
    "a": "AH0", "an": "AE1 N", "the": "DH AH0", "and": "AH0 N D",
    "of": "AH1 V", "to": "T UW1", "in": "IH0 N", "is": "IH1 Z",
    "it": "IH1 T", "that": "DH AE1 T", "was": "W AA1 Z", "he": "HH IY1",
    "she": "SH IY1", "for": "F AO1 R", "on": "AA1 N", "are": "AA1 R",
    "as": "AE1 Z", "with": "W IH1 DH", "his": "HH IH1 Z", "her": "HH ER0",
    "they": "DH EY1", "i": "AY1", "at": "AE1 T", "be": "B IY1",
    "this": "DH IH1 S", "have": "HH AE1 V", "had": "HH AE1 D",
    "has": "HH AE1 Z", "from": "F R AH1 M", "or": "AO1 R",
    "one": "W AH1 N", "by": "B AY1", "word": "W ER1 D", "but": "B AH1 T",
    "not": "N AA1 T", "what": "W AH1 T", "all": "AO1 L",
    "were": "W ER1", "we": "W IY1", "when": "W EH1 N", "your": "Y AO1 R",
    "can": "K AE1 N", "said": "S EH1 D", "there": "DH EH1 R",
    "use": "Y UW1 S", "each": "IY1 CH", "which": "W IH1 CH",
    "do": "D UW1", "how": "HH AW1", "their": "DH EH1 R",
    "if": "IH1 F", "will": "W IH1 L", "up": "AH1 P", "other": "AH1 DH ER0",
    "about": "AH0 B AW1 T", "out": "AW1 T", "many": "M EH1 N IY0",
    "then": "DH EH1 N", "them": "DH EH1 M", "these": "DH IY1 Z",
    "so": "S OW1", "some": "S AH1 M", "would": "W UH1 D",
    "into": "IH0 N T UW1", "who": "HH UW1", "you": "Y UW1",
    "has'nt": "HH AE1 Z AH0 N T",
    "no": "N OW1", "two": "T UW1", "more": "M AO1 R",
    "could": "K UH1 D", "been": "B IH1 N", "now": "N AW1",
    "than": "DH AE1 N", "its": "IH1 T S", "only": "OW1 N L IY0",
    "very": "V EH1 R IY0", "after": "AE1 F T ER0", "any": "EH1 N IY0",
    "our": "AW1 ER0", "over": "OW1 V ER0", "also": "AO1 L S OW0",
    "again": "AH0 G EH1 N", "before": "B IH0 F AO1 R",
    "through": "TH R UW1", "where": "W EH1 R", "being": "B IY1 IH0 NG",
    "because": "B IH0 K AO1 Z", "does": "D AH1 Z", "ever": "EH1 V ER0",
    "once": "W AH1 N S", "down": "D AW1 N", "should": "SH UH1 D",
    "people": "P IY1 P AH0 L", "world": "W ER1 L D",
    "hello": "HH AH0 L OW1", "voice": "V OY1 S",
    "water": "W AO1 T ER0", "first": "F ER1 S T", "time": "T AY1 M",
    "year": "Y IH1 R", "day": "D EY1", "good": "G UH1 D",
    "great": "G R EY1 T", "little": "L IH1 T AH0 L",
    "own": "OW1 N", "say": "S EY1", "says": "S EH1 Z",
    "mr": "M IH1 S T ER0", "mrs": "M IH1 S IH0 Z", "ms": "M IH1 Z",
    "versus": "V ER1 S AH0 S", "avenue": "AE1 V AH0 N UW2",
    "etcetera": "EH2 T S EH1 T ER0 AH0",
    "new": "N UW1", "old": "OW1 L D", "see": "S IY1",
    "way": "W EY1", "may": "M EY1", "come": "K AH1 M",
    "work": "W ER1 K", "made": "M EY1 D", "live": "L IH1 V",
    "give": "G IH1 V", "most": "M OW1 S T", "us": "AH1 S",
    # words from the reference demo texts (update_samples.py:98-101)
    "beginnings": "B IH0 G IH1 N IH0 NG Z",
    "apt": "AE1 P T",
    "determinative": "D IH0 T ER1 M IH0 N AH0 T IH0 V",
    "reinforced": "R IY2 IH0 N F AO1 R S T",
    "continuous": "K AH0 N T IH1 N Y UW0 AH0 S",
    "applications": "AE2 P L AH0 K EY1 SH AH0 N Z",
    "similar": "S IH1 M AH0 L ER0",
    "influence": "IH1 N F L UW0 AH0 N S",
    "restored": "R IH0 S T AO1 R D",
    "courage": "K ER1 IH0 JH",
    "since": "S IH1 N S",
    "conversed": "K AH0 N V ER1 S T",
    "priest": "P R IY1 S T",
    "violent": "V AY1 AH0 L AH0 N T",
    "despair": "D IH0 S P EH1 R",
    "yielded": "Y IY1 L D IH0 D",
    "calm": "K AA1 M",
    "resignation": "R EH2 Z IH0 G N EY1 SH AH0 N",
    "surprised": "S ER0 P R AY1 Z D",
    "knew": "N UW1",
    "excessive": "IH0 K S EH1 S IH0 V",
    "affection": "AH0 F EH1 K SH AH0 N",
    # numbers (feeds the digit expansion)
    "zero": "Z IH1 R OW0", "three": "TH R IY1", "four": "F AO1 R",
    "five": "F AY1 V", "six": "S IH1 K S", "seven": "S EH1 V AH0 N",
    "eight": "EY1 T", "nine": "N AY1 N", "ten": "T EH1 N",
    "eleven": "IH0 L EH1 V AH0 N", "twelve": "T W EH1 L V",
    "thirteen": "TH ER1 T IY1 N", "fourteen": "F AO1 R T IY1 N",
    "fifteen": "F IH1 F T IY1 N", "sixteen": "S IH0 K S T IY1 N",
    "seventeen": "S EH1 V AH0 N T IY1 N",
    "eighteen": "EY0 T IY1 N", "nineteen": "N AY1 N T IY1 N",
    "twenty": "T W EH1 N T IY0", "thirty": "TH ER1 T IY0",
    "forty": "F AO1 R T IY0", "fifty": "F IH1 F T IY0",
    "sixty": "S IH1 K S T IY0", "seventy": "S EH1 V AH0 N T IY0",
    "eighty": "EY1 T IY0", "ninety": "N AY1 N T IY0",
    "hundred": "HH AH1 N D R AH0 D",
    "thousand": "TH AW1 Z AH0 N D",
    "million": "M IH1 L Y AH0 N",
    # common verbs/nouns/adjectives
    "make": "M EY1 K", "take": "T EY1 K",
    "took": "T UH1 K", "get": "G EH1 T", "got": "G AA1 T",
    "go": "G OW1", "went": "W EH1 N T", "gone": "G AO1 N",
    "know": "N OW1", "known": "N OW1 N", "think": "TH IH1 NG K",
    "thought": "TH AO1 T", "came": "K EY1 M",
    "look": "L UH1 K", "want": "W AA1 N T",     "gave": "G EY1 V", "find": "F AY1 N D", "found": "F AW1 N D",
    "tell": "T EH1 L", "told": "T OW1 L D", "ask": "AE1 S K",
    "seem": "S IY1 M", "feel": "F IY1 L", "felt": "F EH1 L T",
    "leave": "L IY1 V", "left": "L EH1 F T", "call": "K AO1 L",
    "put": "P UH1 T", "mean": "M IY1 N", "keep": "K IY1 P",
    "kept": "K EH1 P T", "let": "L EH1 T", "begin": "B IH0 G IH1 N",
    "began": "B IH0 G AE1 N", "show": "SH OW1", "hear": "HH IY1 R",
    "heard": "HH ER1 D", "play": "P L EY1", "run": "R AH1 N",
    "move": "M UW1 V", "like": "L AY1 K", "believe": "B IH0 L IY1 V",
    "hold": "HH OW1 L D", "held": "HH EH1 L D", "bring": "B R IH1 NG",
    "brought": "B R AO1 T", "happen": "HH AE1 P AH0 N",
    "write": "R AY1 T", "written": "R IH1 T AH0 N",
    "wrote": "R OW1 T", "read": "R IY1 D", "sit": "S IH1 T",
    "sat": "S AE1 T", "stand": "S T AE1 N D", "stood": "S T UH1 D",
    "lose": "L UW1 Z", "lost": "L AO1 S T", "pay": "P EY1",
    "meet": "M IY1 T", "met": "M EH1 T",
    "include": "IH0 N K L UW1 D", "continue": "K AH0 N T IH1 N Y UW0",
    "set": "S EH1 T", "learn": "L ER1 N", "change": "CH EY1 N JH",
    "lead": "L IY1 D", "watch": "W AA1 CH", "follow": "F AA1 L OW0",
    "stop": "S T AA1 P", "create": "K R IY0 EY1 T",
    "speak": "S P IY1 K", "spoke": "S P OW1 K",
    "spend": "S P EH1 N D", "spent": "S P EH1 N T",
    "grow": "G R OW1", "grew": "G R UW1", "open": "OW1 P AH0 N",
    "walk": "W AO1 K", "win": "W IH1 N", "won": "W AH1 N",
    "offer": "AO1 F ER0", "love": "L AH1 V", "consider": "K AH0 N S IH1 D ER0",
    "appear": "AH0 P IH1 R", "buy": "B AY1", "bought": "B AO1 T",
    "wait": "W EY1 T", "serve": "S ER1 V", "die": "D AY1",
    "send": "S EH1 N D", "sent": "S EH1 N T", "expect": "IH0 K S P EH1 K T",
    "build": "B IH1 L D", "built": "B IH1 L T", "stay": "S T EY1",
    "fall": "F AO1 L", "fell": "F EH1 L", "cut": "K AH1 T",
    "reach": "R IY1 CH", "kill": "K IH1 L", "remain": "R IH0 M EY1 N",
    "man": "M AE1 N", "men": "M EH1 N", "woman": "W UH1 M AH0 N",
    "women": "W IH1 M AH0 N", "child": "CH AY1 L D",
    "children": "CH IH1 L D R AH0 N", "life": "L AY1 F",
    "hand": "HH AE1 N D", "part": "P AA1 R T", "eye": "AY1",
    "eyes": "AY1 Z", "place": "P L EY1 S", "case": "K EY1 S",
    "week": "W IY1 K", "company": "K AH1 M P AH0 N IY0",
    "system": "S IH1 S T AH0 M", "program": "P R OW1 G R AE2 M",
    "number": "N AH1 M B ER0", "night": "N AY1 T", "point": "P OY1 N T",
    "home": "HH OW1 M", "room": "R UW1 M", "mother": "M AH1 DH ER0",
    "father": "F AA1 DH ER0", "money": "M AH1 N IY0", "story": "S T AO1 R IY0",
    "fact": "F AE1 K T", "month": "M AH1 N TH", "lot": "L AA1 T",
    "right": "R AY1 T", "study": "S T AH1 D IY0", "book": "B UH1 K",
    "business": "B IH1 Z N AH0 S",
    "issue": "IH1 SH UW0", "side": "S AY1 D", "kind": "K AY1 N D",
    "head": "HH EH1 D", "house": "HH AW1 S", "friend": "F R EH1 N D",
    "hour": "AW1 ER0", "game": "G EY1 M", "line": "L AY1 N",
    "end": "EH1 N D", "member": "M EH1 M B ER0", "law": "L AO1",
    "car": "K AA1 R", "city": "S IH1 T IY0", "name": "N EY1 M",
    "team": "T IY1 M", "minute": "M IH1 N AH0 T", "idea": "AY0 D IY1 AH0",
    "body": "B AA1 D IY0", "face": "F EY1 S", "others": "AH1 DH ER0 Z",
    "level": "L EH1 V AH0 L", "door": "D AO1 R", "health": "HH EH1 L TH",
    "person": "P ER1 S AH0 N", "art": "AA1 R T", "war": "W AO1 R",
    "history": "HH IH1 S T ER0 IY0", "party": "P AA1 R T IY0",
    "result": "R IH0 Z AH1 L T", "reason": "R IY1 Z AH0 N", "research": "R IY1 S ER0 CH",
    "air": "EH1 R", "force": "F AO1 R S",
    "state": "S T EY1 T", "area": "EH1 R IY0 AH0",
    "music": "M Y UW1 Z IH0 K", "mind": "M AY1 N D",
    "high": "HH AY1", "small": "S M AO1 L",
    "large": "L AA1 R JH", "big": "B IH1 G", "long": "L AO1 NG",
    "young": "Y AH1 NG", "few": "F Y UW1",
    "public": "P AH1 B L IH0 K", "bad": "B AE1 D",
    "same": "S EY1 M", "able": "EY1 B AH0 L", "last": "L AE1 S T",
    "early": "ER1 L IY0", "late": "L EY1 T", "hard": "HH AA1 R D", "far": "F AA1 R",
    "real": "R IY1 L", "best": "B EH1 S T", "sure": "SH UH1 R",
    "better": "B EH1 T ER0", "true": "T R UW1", "whole": "HH OW1 L",
    "certain": "S ER1 T AH0 N", "free": "F R IY1", "full": "F UH1 L",
    "special": "S P EH1 SH AH0 L", "easy": "IY1 Z IY0",
    "clear": "K L IH1 R", "strong": "S T R AO1 NG",
    "never": "N EH1 V ER0", "here": "HH IY1 R", "still": "S T IH1 L",
    "well": "W EH1 L", "just": "JH AH1 S T", "even": "IY1 V AH0 N",
    "back": "B AE1 K", "much": "M AH1 CH", "today": "T AH0 D EY1",
    "however": "HH AW2 EH1 V ER0", "almost": "AO1 L M OW2 S T",
    "enough": "IH0 N AH1 F", "both": "B OW1 TH",
    "between": "B IH0 T W IY1 N", "under": "AH1 N D ER0",
    "against": "AH0 G EH1 N S T", "during": "D UH1 R IH0 NG",
    "without": "W IH0 TH AW1 T", "around": "ER0 AW1 N D",
    "among": "AH0 M AH1 NG", "within": "W IH0 DH IH1 N",
    "upon": "AH0 P AA1 N", "toward": "T AH0 W AO1 R D",
    "sound": "S AW1 N D", "speech": "S P IY1 CH",
    # frequent words whose spelling-to-sound is irregular (rule engine
    # gets these systematically wrong)
    "ones": "W AH1 N Z",     "busy": "B IH1 Z IY0",     "pretty": "P R IH1 T IY0",     "island": "AY1 L AH0 N D",
    "islands": "AY1 L AH0 N D Z", "iron": "AY1 ER0 N",
    "answer": "AE1 N S ER0", "answered": "AE1 N S ER0 D",
    "sword": "S AO1 R D", "listen": "L IH1 S AH0 N",
    "listened": "L IH1 S AH0 N D", "often": "AO1 F AH0 N",
    "castle": "K AE1 S AH0 L", "whistle": "W IH1 S AH0 L",
    "christmas": "K R IH1 S M AH0 S", "colonel": "K ER1 N AH0 L",
    "stomach": "S T AH1 M AH0 K", "ache": "EY1 K",
    "heart": "HH AA1 R T", "hearts": "HH AA1 R T S",
    "earth": "ER1 TH",     "learned": "L ER1 N D",
    "search": "S ER1 CH", "heaven": "HH EH1 V AH0 N",
    "heavy": "HH EH1 V IY0", "measure": "M EH1 ZH ER0", "pleasure": "P L EH1 ZH ER0",
    "treasure": "T R EH1 ZH ER0", "leather": "L EH1 DH ER0",
    "instead": "IH0 N S T EH1 D", "already": "AO0 L R EH1 D IY0",
    "ready": "R EH1 D IY0", "dead": "D EH1 D", "death": "D EH1 TH",
    "breath": "B R EH1 TH", "breast": "B R EH1 S T",
    "bread": "B R EH1 D", "meant": "M EH1 N T",
    "pleasant": "P L EH1 Z AH0 N T", "peasant": "P EH1 Z AH0 N T",
    "jealous": "JH EH1 L AH0 S", "zealous": "Z EH1 L AH0 S",
    "realm": "R EH1 L M", "dealt": "D EH1 L T", "sweat": "S W EH1 T",
    "threat": "TH R EH1 T", "wealth": "W EH1 L TH",
    "touch": "T AH1 CH", "touched": "T AH1 CH T",
    "trouble": "T R AH1 B AH0 L", "country": "K AH1 N T R IY0",
    "countries": "K AH1 N T R IY0 Z", "cousin": "K AH1 Z AH0 N",
    "couple": "K AH1 P AH0 L",     "journey": "JH ER1 N IY0", "course": "K AO1 R S",
    "court": "K AO1 R T", "pour": "P AO1 R",
    "soul": "S OW1 L", "shoulder": "SH OW1 L D ER0",
    "though": "DH OW1", "although": "AO0 L DH OW1",
    "thorough": "TH ER1 OW0",     "throughout": "TH R UW0 AW1 T",     "fought": "F AO1 T", "sought": "S AO1 T",
    "caught": "K AO1 T", "taught": "T AO1 T", "daughter": "D AO1 T ER0",
    "laugh": "L AE1 F", "laughed": "L AE1 F T",
    "laughter": "L AE1 F T ER0", "draught": "D R AE1 F T",
    "rough": "R AH1 F", "tough": "T AH1 F",
    "cough": "K AO1 F", "dough": "D OW1",
    "neighbor": "N EY1 B ER0", "neighbour": "N EY1 B ER0",
    "weigh": "W EY1", "weight": "W EY1 T", "height": "HH AY1 T",
    "eighth": "EY1 T TH", "straight": "S T R EY1 T",
    "foreign": "F AO1 R AH0 N", "reign": "R EY1 N",
    "friends": "F R EH1 N D Z",
    "guest": "G EH1 S T", "guess": "G EH1 S", "guard": "G AA1 R D",
    "guide": "G AY1 D", "guilty": "G IH1 L T IY0",
    "biscuit": "B IH1 S K AH0 T", "circuit": "S ER1 K AH0 T",
    "blood": "B L AH1 D", "flood": "F L AH1 D",
    "floor": "F L AO1 R", "poor": "P UH1 R",
    "sugar": "SH UH1 G ER0",     "surely": "SH UH1 R L IY0", "machine": "M AH0 SH IY1 N",
    "machines": "M AH0 SH IY1 N Z", "police": "P AH0 L IY1 S",
    "unique": "Y UW0 N IY1 K", "antique": "AE0 N T IY1 K",
    "bureau": "B Y UH1 R OW0", "beautiful": "B Y UW1 T AH0 F AH0 L",
    "beauty": "B Y UW1 T IY0", "europe": "Y UH1 R AH0 P",
    "european": "Y UH2 R AH0 P IY1 AH0 N",
    "ocean": "OW1 SH AH0 N", "soldier": "S OW1 L JH ER0",
    "soldiers": "S OW1 L JH ER0 Z", "shoe": "SH UW1",
    "shoes": "SH UW1 Z", "canoe": "K AH0 N UW1",     "done": "D AH1 N", "none": "N AH1 N",     "moved": "M UW1 V D", "prove": "P R UW1 V",
    "proved": "P R UW1 V D", "whose": "HH UW1 Z",
    "whom": "HH UW1 M", "tomb": "T UW1 M", "womb": "W UW1 M",
    "comb": "K OW1 M", "climb": "K L AY1 M", "limb": "L IH1 M",
    "thumb": "TH AH1 M", "numb": "N AH1 M", "debt": "D EH1 T",
    "doubt": "D AW1 T", "doubtless": "D AW1 T L AH0 S",
    "subtle": "S AH1 T AH0 L", "receipt": "R IH0 S IY1 T",
    "honest": "AA1 N AH0 S T", "honor": "AA1 N ER0",
    "honour": "AA1 N ER0", "heir": "EH1 R", "ghost": "G OW1 S T",
    "echo": "EH1 K OW0", "chorus": "K AO1 R AH0 S",
    "character": "K EH1 R IH0 K T ER0",
    "characters": "K EH1 R IH0 K T ER0 Z",
    "chemist": "K EH1 M IH0 S T", "chemistry": "K EH1 M AH0 S T R IY0",
    "school": "S K UW1 L", "schools": "S K UW1 L Z",
    "scholar": "S K AA1 L ER0", "christian": "K R IH1 S CH AH0 N",
    "anchor": "AE1 NG K ER0", "architect": "AA1 R K AH0 T EH2 K T",
    "monarch": "M AA1 N AA0 R K", "epoch": "EH1 P AH0 K",
    "orchestra": "AO1 R K AH0 S T R AH0",
    "technical": "T EH1 K N IH0 K AH0 L",
    "wanted": "W AA1 N T IH0 D",
    "asked": "AE1 S K T", "looked": "L UH1 K T",
    "aisle": "AY1 L",
    "quite": "K W AY1 T", "quiet": "K W AY1 AH0 T",
    "behind": "B IH0 HH AY1 N D", "blind": "B L AY1 N D",
    "wild": "W AY1 L D",     "sign": "S AY1 N", "signs": "S AY1 N Z", "design": "D IH0 Z AY1 N",
    "signed": "S AY1 N D", "resign": "R IH0 Z AY1 N",
    "signal": "S IH1 G N AH0 L", "signature": "S IH1 G N AH0 CH ER0",
    "half": "HH AE1 F", "calf": "K AE1 F", "talk": "T AO1 K",
    "walked": "W AO1 K T", "chalk": "CH AO1 K",
    "folk": "F OW1 K", "yolk": "Y OW1 K", "salmon": "S AE1 M AH0 N",
    "palm": "P AA1 M", "psalm": "S AA1 M",
    "shall": "SH AE1 L", "wants": "W AA1 N T S",
    "watched": "W AA1 CH T",
    "wash": "W AA1 SH", "wander": "W AA1 N D ER0",
    "quality": "K W AA1 L AH0 T IY0", "quantity": "K W AA1 N T AH0 T IY0",
    "quarrel": "K W AO1 R AH0 L", "squad": "S K W AA1 D",
    "warm": "W AO1 R M", "warn": "W AO1 R N",
    "towards": "T AH0 W AO1 R D Z",
    "reward": "R IH0 W AO1 R D", "dwarf": "D W AO1 R F",
    "swan": "S W AA1 N", "swap": "S W AA1 P",
    "words": "W ER1 D Z",     "worked": "W ER1 K T", "worker": "W ER1 K ER0",
    "workers": "W ER1 K ER0 Z", "worse": "W ER1 S",
    "worst": "W ER1 S T", "worth": "W ER1 TH", "worthy": "W ER1 DH IY0",
    "worship": "W ER1 SH AH0 P", "worm": "W ER1 M",
    "front": "F R AH1 N T",     "months": "M AH1 N TH S", "monday": "M AH1 N D EY2",
    "monkey": "M AH1 NG K IY0",     "honey": "HH AH1 N IY0",     "amongst": "AH0 M AH1 NG S T",
    "son": "S AH1 N", "sons": "S AH1 N Z", "ton": "T AH1 N",
    "wonder": "W AH1 N D ER0",
    "wonderful": "W AH1 N D ER0 F AH0 L",
    "nothing": "N AH1 TH IH0 NG",     "brother": "B R AH1 DH ER0",     "another": "AH0 N AH1 DH ER0",     "glove": "G L AH1 V", "gloves": "G L AH1 V Z",
    "above": "AH0 B AH1 V", "loved": "L AH1 V D",
    "dove": "D AH1 V", "oven": "AH1 V AH0 N", "cover": "K AH1 V ER0",
    "covered": "K AH1 V ER0 D", "govern": "G AH1 V ER0 N",
    "color": "K AH1 L ER0",
    "colour": "K AH1 L ER0", "comfort": "K AH1 M F ER0 T",
    "common": "K AA1 M AH0 N", "compass": "K AH1 M P AH0 S",
    "onion": "AH1 N Y AH0 N", "dozen": "D AH1 Z AH0 N",
    "become": "B IH0 K AH1 M", "became": "B IH0 K EY1 M",
    "welcome": "W EH1 L K AH0 M", "income": "IH1 N K AH2 M",
    "somebody": "S AH1 M B AA2 D IY0",
    "something": "S AH1 M TH IH0 NG", "sometimes": "S AH0 M T AY1 M Z",
    "somewhat": "S AH1 M W AH2 T", "somewhere": "S AH1 M W EH2 R",
    "stone": "S T OW1 N", "stones": "S T OW1 N Z",
    "alone": "AH0 L OW1 N", "bone": "B OW1 N", "tone": "T OW1 N",
    "scene": "S IY1 N", "scent": "S EH1 N T",
    "science": "S AY1 AH0 N S", "scissors": "S IH1 Z ER0 Z",
    "muscle": "M AH1 S AH0 L", "fasten": "F AE1 S AH0 N",
    "soften": "S AO1 F AH0 N", "hasten": "HH EY1 S AH0 N",
    "wednesday": "W EH1 N Z D EY2", "february": "F EH1 B Y AH0 W EH2 R IY0",
    "library": "L AY1 B R EH2 R IY0",
    "necessary": "N EH1 S AH0 S EH2 R IY0",
    "secretary": "S EH1 K R AH0 T EH2 R IY0",
    "interesting": "IH1 N T R AH0 S T IH0 NG",
    "interest": "IH1 N T R AH0 S T",
    "evening": "IY1 V N IH0 NG", "every": "EH1 V ER0 IY0",
    "everything": "EH1 V R IY0 TH IH2 NG",
    "everyone": "EH1 V R IY0 W AH2 N",
    "several": "S EH1 V R AH0 L", "general": "JH EH1 N ER0 AH0 L",
    "camera": "K AE1 M ER0 AH0", "family": "F AE1 M AH0 L IY0",
    "favorite": "F EY1 V ER0 IH0 T", "favourite": "F EY1 V ER0 IH0 T",
    "temperature": "T EH1 M P R AH0 CH ER0",
    "restaurant": "R EH1 S T ER0 AA2 N T",
    "chocolate": "CH AO1 K L AH0 T",
    "vegetable": "V EH1 JH T AH0 B AH0 L",
    "miniature": "M IH1 N IY0 AH0 CH ER0",
    "suit": "S UW1 T", "fruit": "F R UW1 T", "juice": "JH UW1 S",
    "bruise": "B R UW1 Z", "cruise": "K R UW1 Z",
    "nuisance": "N UW1 S AH0 N S", "pursuit": "P ER0 S UW1 T",
    "minutes": "M IH1 N AH0 T S",
    "lettuce": "L EH1 T AH0 S", "purpose": "P ER1 P AH0 S",
    "promise": "P R AA1 M AH0 S", "surface": "S ER1 F AH0 S",
    "palace": "P AE1 L AH0 S", "village": "V IH1 L AH0 JH",
    "image": "IH1 M AH0 JH", "damage": "D AE1 M AH0 JH",
    "marriage": "M EH1 R IH0 JH",
    "carriage": "K AE1 R IH0 JH", "knowledge": "N AA1 L IH0 JH",
    "college": "K AA1 L IH0 JH", "orange": "AO1 R AH0 N JH",
    "porridge": "P AO1 R IH0 JH", "message": "M EH1 S AH0 JH",
    "passage": "P AE1 S AH0 JH", "garbage": "G AA1 R B IH0 JH",
    "usage": "Y UW1 S AH0 JH", "luggage": "L AH1 G AH0 JH",
    "average": "AE1 V ER0 IH0 JH", "savage": "S AE1 V AH0 JH",
    "cottage": "K AA1 T AH0 JH", "cabbage": "K AE1 B AH0 JH",
    "captain": "K AE1 P T AH0 N",     "certainly": "S ER1 T AH0 N L IY0", "curtain": "K ER1 T AH0 N",
    "fountain": "F AW1 N T AH0 N", "mountains": "M AW1 N T AH0 N Z", "bargain": "B AA1 R G AH0 N",
    "villain": "V IH1 L AH0 N", "britain": "B R IH1 T AH0 N",
    "ancient": "EY1 N CH AH0 N T", "patient": "P EY1 SH AH0 N T",
    "patience": "P EY1 SH AH0 N S", "anxious": "AE1 NG K SH AH0 S",
    "anxiety": "AE0 NG Z AY1 AH0 T IY0",
    "luxury": "L AH1 G ZH ER0 IY0", "exact": "IH0 G Z AE1 K T",
    "exactly": "IH0 G Z AE1 K T L IY0",
    "examine": "IH0 G Z AE1 M AH0 N", "exist": "IH0 G Z IH1 S T",
    "exhaust": "IH0 G Z AO1 S T", "exhibit": "IH0 G Z IH1 B IH0 T",
    "exert": "IH0 G Z ER1 T", "executive": "IH0 G Z EH1 K Y AH0 T IH0 V",
    "anger": "AE1 NG G ER0", "angry": "AE1 NG G R IY0",
    "hunger": "HH AH1 NG G ER0", "hungry": "HH AH1 NG G R IY0",
    "finger": "F IH1 NG G ER0", "fingers": "F IH1 NG G ER0 Z",
    "longer": "L AO1 NG G ER0", "stronger": "S T R AO1 NG G ER0",
    "younger": "Y AH1 NG G ER0", "single": "S IH1 NG G AH0 L",
    "singer": "S IH1 NG ER0", "danger": "D EY1 N JH ER0",
    "stranger": "S T R EY1 N JH ER0",
    "strange": "S T R EY1 N JH", "angel": "EY1 N JH AH0 L",
    "ginger": "JH IH1 N JH ER0", "engine": "EH1 N JH AH0 N",
    "engineer": "EH2 N JH AH0 N IH1 R",
    "suggest": "S AH0 G JH EH1 S T",
    "ideas": "AY0 D IY1 AH0 Z",     "really": "R IH1 L IY0",     "created": "K R IY0 EY1 T IH0 D", "theater": "TH IY1 AH0 T ER0",
    "theatre": "TH IY1 AH0 T ER0", "react": "R IY0 AE1 K T",
    "ahead": "AH0 HH EH1 D", "apart": "AH0 P AA1 R T",
    "away": "AH0 W EY1", "across": "AH0 K R AO1 S",
    "along": "AH0 L AO1 NG", "amount": "AH0 M AW1 N T",
    "appeared": "AH0 P IH1 R D",
    "attack": "AH0 T AE1 K", "attempt": "AH0 T EH1 M P T",
    "attention": "AH0 T EH1 N SH AH0 N",
    # French loanwords the -ache compound rule must not touch
    "panache": "P AH0 N AE1 SH", "apache": "AH0 P AE1 CH IY0",
    "attache": "AE2 T AH0 SH EY1", "suave": "S W AA1 V",
    "arrive": "ER0 AY1 V", "arrived": "ER0 AY1 V D",
    "allow": "AH0 L AW1", "allowed": "AH0 L AW1 D",
    "agree": "AH0 G R IY1", "agreed": "AH0 G R IY1 D",
    "afraid": "AH0 F R EY1 D", "ago": "AH0 G OW1",
    "asleep": "AH0 S L IY1 P", "awake": "AH0 W EY1 K",
    "alive": "AH0 L AY1 V", "alike": "AH0 L AY1 K",
    "abroad": "AH0 B R AO1 D", "aboard": "AH0 B AO1 R D",
    "account": "AH0 K AW1 N T", "accept": "AE0 K S EH1 P T",
    "accident": "AE1 K S AH0 D AH0 N T",
    "success": "S AH0 K S EH1 S", "succeed": "S AH0 K S IY1 D",
    "access": "AE1 K S EH2 S", "occasion": "AH0 K EY1 ZH AH0 N",
    "o'clock": "AH0 K L AA1 K", "gentleman": "JH EH1 N T AH0 L M AH0 N",
    "gentlemen": "JH EH1 N T AH0 L M IH0 N",
    "perhaps": "P ER0 HH AE1 P S", "position": "P AH0 Z IH1 SH AH0 N",
    "present": "P R EH1 Z AH0 N T", "presence": "P R EH1 Z AH0 N S",
    "prison": "P R IH1 Z AH0 N", "prisoner": "P R IH1 Z AH0 N ER0",
    "season": "S IY1 Z AH0 N",
    "resemble": "R IH0 Z EH1 M B AH0 L",
    "deserve": "D IH0 Z ER1 V", "desire": "D IH0 Z AY1 ER0",
    "observe": "AH0 B Z ER1 V", "observed": "AH0 B Z ER1 V D",
    "visit": "V IH1 Z AH0 T", "visited": "V IH1 Z AH0 T IH0 D",
    "usual": "Y UW1 ZH AH0 W AH0 L",
    "usually": "Y UW1 ZH AH0 W AH0 L IY0",
    "vision": "V IH1 ZH AH0 N",
    "division": "D IH0 V IH1 ZH AH0 N",
    "decision": "D IH0 S IH1 ZH AH0 N",
    "occasionally": "AH0 K EY1 ZH AH0 N AH0 L IY0",
    "billion": "B IH1 L Y AH0 N",
    "familiar": "F AH0 M IH1 L Y ER0", "opinion": "AH0 P IH1 N Y AH0 N",
    "companion": "K AH0 M P AE1 N Y AH0 N",
    "behavior": "B IH0 HH EY1 V Y ER0",
    "behaviour": "B IH0 HH EY1 V Y ER0",
    "brilliant": "B R IH1 L Y AH0 N T",
    "william": "W IH1 L Y AH0 M", "junior": "JH UW1 N Y ER0",
    "senior": "S IY1 N Y ER0", "union": "Y UW1 N Y AH0 N",
    # "ow" as /AW/ (the ow->OW rule default misses these)
    "brown": "B R AW1 N", "town": "T AW1 N", "towns": "T AW1 N Z",
    "gown": "G AW1 N", "crown": "K R AW1 N", "drown": "D R AW1 N",
    "clown": "K L AW1 N", "frown": "F R AW1 N", "crowd": "K R AW1 D",
    "owl": "AW1 L", "vowel": "V AW1 AH0 L", "towel": "T AW1 AH0 L",
    "tower": "T AW1 ER0",
    "shower": "SH AW1 ER0", "coward": "K AW1 ER0 D",
    "brow": "B R AW1", "plow": "P L AW1", "allowance": "AH0 L AW1 AH0 N S",
    # further frequent irregular spellings
    "yacht": "Y AA1 T", "choir": "K W AY1 ER0", "bury": "B EH1 R IY0",
    "buried": "B EH1 R IY0 D", "sew": "S OW1", "sewn": "S OW1 N",
    "asthma": "AE1 Z M AH0", "isle": "AY1 L",     "hymn": "HH IH1 M", "column": "K AA1 L AH0 M", "solemn": "S AA1 L AH0 M",
    "condemn": "K AH0 N D EH1 M", "wrist": "R IH1 S T",
    "wrestle": "R EH1 S AH0 L",
    "bustle": "B AH1 S AH0 L", "hustle": "HH AH1 S AH0 L",
    "rustle": "R AH1 S AH0 L", "bristle": "B R IH1 S AH0 L",
    "thistle": "TH IH1 S AH0 L", "gristle": "G R IH1 S AH0 L",
    "glisten": "G L IH1 S AH0 N",
    "moisten": "M OY1 S AH0 N", "christen": "K R IH1 S AH0 N",
    "debris": "D AH0 B R IY1",
    "corps": "K AO1 R", "depot": "D IY1 P OW0",
    "ballet": "B AE0 L EY1", "buffet": "B AH0 F EY1",
    "bouquet": "B UW0 K EY1", "crochet": "K R OW0 SH EY1",
    "gourmet": "G UH0 R M EY1", "valet": "V AE0 L EY1",
    "cafe": "K AH0 F EY1", "cliche": "K L IY0 SH EY1",
    "fiance": "F IY0 AA1 N S EY2", "resume": "R IH0 Z UW1 M",
    "genre": "ZH AA1 N R AH0", "rendezvous": "R AA1 N D IH0 V UW2",
    "lieutenant": "L UW0 T EH1 N AH0 N T",
    "sergeant": "S AA1 R JH AH0 N T", "bologna": "B AH0 L OW1 N IY0",
    "champagne": "SH AE0 M P EY1 N", "chauffeur": "SH OW0 F ER1",
    "chandelier": "SH AE2 N D AH0 L IH1 R",
    "brochure": "B R OW0 SH UH1 R", "parachute": "P EH1 R AH0 SH UW2 T",
    "machete": "M AH0 SH EH1 T IY0", "mustache": "M AH1 S T AE2 SH",
    "cache": "K AE1 SH", "niche": "N IH1 CH",
    "quiche": "K IY1 SH", "chassis": "CH AE1 S IY0",
    "chaos": "K EY1 AA0 S",     "chrome": "K R OW1 M", "chronic": "K R AA1 N IH0 K",
    "chemise": "SH AH0 M IY1 Z", "charade": "SH ER0 EY1 D",
    "pneumonia": "N UW0 M OW1 N Y AH0",
    "psychology": "S AY0 K AA1 L AH0 JH IY0",
    "pseudo": "S UW1 D OW0",
    "rhythm": "R IH1 DH AH0 M", "rhyme": "R AY1 M",
    "rhubarb": "R UW1 B AA2 R B", "ghetto": "G EH1 T OW0",
    "gherkin": "G ER1 K AH0 N", "ghoul": "G UW1 L",
    "guitar": "G IH0 T AA1 R", "guinea": "G IH1 N IY0",
    "guilt": "G IH1 L T", "guise": "G AY1 Z",
    "disguise": "D IH0 S G AY1 Z", "guarantee": "G EH2 R AH0 N T IY1",
    "tongue": "T AH1 NG", "vague": "V EY1 G",
    "league": "L IY1 G", "fatigue": "F AH0 T IY1 G",
    "intrigue": "IH0 N T R IY1 G", "plague": "P L EY1 G",
    "morgue": "M AO1 R G", "rogue": "R OW1 G",
    "catalogue": "K AE1 T AH0 L AO2 G", "dialogue": "D AY1 AH0 L AO2 G",
    "queue": "K Y UW1", "plaque": "P L AE1 K",
    "technique": "T EH0 K N IY1 K",
    "physique": "F IH0 Z IY1 K", "critique": "K R IH0 T IY1 K",
    "oblique": "OW0 B L IY1 K", "cheque": "CH EH1 K",
    "mosque": "M AA1 S K", "grotesque": "G R OW0 T EH1 S K",
    "picturesque": "P IH2 K CH ER0 EH1 S K",
    "sovereign": "S AA1 V R AH0 N", "campaign": "K AE0 M P EY1 N",
    "cologne": "K AH0 L OW1 N",     "gnome": "N OW1 M", "gnaw": "N AO1", "gnat": "N AE1 T",
    "feign": "F EY1 N", "deign": "D EY1 N",
    "diaphragm": "D AY1 AH0 F R AE2 M",
    "paradigm": "P EH1 R AH0 D AY2 M",
    "indict": "IH0 N D AY1 T", "indictment": "IH0 N D AY1 T M AH0 N T",
    "victuals": "V IH1 T AH0 L Z", "viscount": "V AY1 K AW2 N T",
    "heirloom": "EH1 R L UW2 M", "honesty": "AA1 N AH0 S T IY0",
    "hors": "AO1 R", "herb": "ER1 B", "heiress": "EH1 R AH0 S",
    "one's": "W AH1 N Z", "two's": "T UW1 Z",
    "women's": "W IH1 M AH0 N Z", "men's": "M EH1 N Z",
    "people's": "P IY1 P AH0 L Z",
    "clothes": "K L OW1 DH Z", "clothing": "K L OW1 DH IH0 NG",
    "cupboard": "K AH1 B ER0 D", "forehead": "F AO1 R HH EH2 D",
    "vineyard": "V IH1 N Y ER0 D", "shepherd": "SH EH1 P ER0 D",
    "orchard": "AO1 R CH ER0 D", "vehicle": "V IY1 IH0 K AH0 L",
    "vehicles": "V IY1 IH0 K AH0 L Z",
    "recipe": "R EH1 S AH0 P IY0", "epitome": "IH0 P IH1 T AH0 M IY0",
    "apostrophe": "AH0 P AA1 S T R AH0 F IY0",
    "catastrophe": "K AH0 T AE1 S T R AH0 F IY0",
    "hyperbole": "HH AY0 P ER1 B AH0 L IY0",
    "simile": "S IH1 M AH0 L IY0",
    "coyote": "K AY0 OW1 T IY0", "karate": "K ER0 AA1 T IY0",
    "adobe": "AH0 D OW1 B IY0", "posse": "P AA1 S IY0",
    "sesame": "S EH1 S AH0 M IY0", "finale": "F IH0 N AE1 L IY0",
    # money/law/time band (twenty-third probe): reduction-vowel pins
    # (CMU uses AH0 where the rules emit IH0 and vice versa), silent-t
    # mortgage, palatalized schedule, nn-blocked prefixes
    "mortgage": "M AO1 R G AH0 JH", "lawyer": "L AO1 Y ER0",
    "jury": "JH UH1 R IY0", "credit": "K R EH1 D AH0 T",
    "debit": "D EH1 B IH0 T", "justice": "JH AH1 S T AH0 S",
    "evidence": "EH1 V AH0 D AH0 N S",
    "innocent": "IH1 N AH0 S AH0 N T",
    "innocence": "IH1 N AH0 S AH0 N S",
    "innovate": "IH1 N AH0 V EY2 T",
    "innovation": "IH2 N AH0 V EY1 SH AH0 N",
    "criminal": "K R IH1 M AH0 N AH0 L",
    "decade": "D EH1 K EY0 D", "schedule": "S K EH1 JH UW0 L",
    "annual": "AE1 N Y UW0 AH0 L", "casual": "K AE1 ZH AH0 W AH0 L",
    "illegal": "IH2 L IY1 G AH0 L", "limit": "L IH1 M AH0 T",
    "fatal": "F EY1 T AH0 L", "vital": "V AY1 T AH0 L",
    "total": "T OW1 T AH0 L", "erase": "IH0 R EY1 S",
    "disease": "D IH0 Z IY1 Z",
    # occupations/workplace band (twenty-fourth probe, 12/24 blind
    # before the -geon/-itor/-line/final-ice/silent-mb-derivative
    # rules and the geminate+liquid prefix destress)
    "plumber": "P L AH1 M ER0",
    "carpenter": "K AA1 R P AH0 N T ER0",
    "electrician": "IH0 L EH0 K T R IH1 SH AH0 N",
    "surgeon": "S ER1 JH AH0 N",
    "accountant": "AH0 K AW1 N T AH0 N T",
    "janitor": "JH AE1 N AH0 T ER0",
    "receptionist": "R IH0 S EH1 P SH AH0 N IH0 S T",
    "colleague": "K AA1 L IY0 G",
    "interview": "IH1 N T ER0 V Y UW2",
    "deadline": "D EH1 D L AY2 N",
    "promotion": "P R AH0 M OW1 SH AH0 N",
    "employee": "EH2 M P L OY1 IY0",
    "employer": "EH0 M P L OY1 ER0",
    "wage": "W EY1 JH",
    "overtime": "OW1 V ER0 T AY2 M",
    "retirement": "R IH0 T AY1 ER0 M AH0 N T",
    "salesman": "S EY1 L Z M AH0 N",
    "apprentice": "AH0 P R EH1 N T AH0 S",
    # neighbor pins from the same band's rule work
    "advice": "AH0 D V AY1 S", "device": "D IH0 V AY1 S",
    "discipline": "D IH1 S AH0 P L AH0 N",
    "monitor": "M AA1 N AH0 T ER0", "editor": "EH1 D AH0 T ER0",
    "practice": "P R AE1 K T AH0 S", "service": "S ER1 V AH0 S",
    "pigeon": "P IH1 JH AH0 N", "bomber": "B AA1 M ER0",
    "headline": "HH EH1 D L AY2 N",
    "gasoline": "G AE1 S AH0 L IY2 N",
    "attract": "AH0 T R AE1 K T", "approve": "AH0 P R UW1 V",
    "decline": "D IH0 K L AY1 N",
    # vehicles/transportation band (twenty-fifth probe, 17/24 blind
    # before the cy-cle/-rian/license/motor/commute rules)
    "motorcycle": "M OW1 T ER0 S AY2 K AH0 L",
    "motor": "M OW1 T ER0", "highway": "HH AY1 W EY2",
    "license": "L AY1 S AH0 N S",
    "diesel": "D IY1 Z AH0 L", "mechanic": "M AH0 K AE1 N IH0 K",
    "brake": "B R EY1 K", "clutch": "K L AH1 CH",
    "mileage": "M AY1 L AH0 JH",
    "passenger": "P AE1 S AH0 N JH ER0",
    "pedestrian": "P AH0 D EH1 S T R IY0 AH0 N",
    "intersection": "IH2 N T ER0 S EH1 K SH AH0 N",
    "roundabout": "R AW1 N D AH0 B AW2 T",
    "accelerate": "AH0 K S EH1 L ER0 EY2 T",
    "tunnel": "T AH1 N AH0 L",
    "freight": "F R EY1 T", "caution": "K AO1 SH AH0 N",
    "detour": "D IY1 T UH0 R", "commute": "K AH0 M Y UW1 T",
    "commuter": "K AH0 M Y UW1 T ER0",
    "recycle": "R IY0 S AY1 K AH0 L",
    "cyclone": "S AY1 K L OW2 N",
    # science/education band (twenty-sixth probe, 15/24 blind before
    # the al-/-sis/-iment/-cil/home-/-less/e+r-destress rules)
    "mathematics": "M AE2 TH AH0 M AE1 T IH0 K S",
    "geometry": "JH IY0 AA1 M AH0 T R IY0",
    "algebra": "AE1 L JH AH0 B R AH0",
    "laboratory": "L AE1 B R AH0 T AO2 R IY0",
    "experiment": "IH0 K S P EH1 R AH0 M AH0 N T",
    "hypothesis": "HH AY0 P AA1 TH AH0 S AH0 S",
    "molecule": "M AA1 L AH0 K Y UW2 L",
    "theory": "TH IY1 ER0 IY0",
    "university": "Y UW2 N AH0 V ER1 S AH0 T IY0",
    "lecture": "L EH1 K CH ER0",
    "homework": "HH OW1 M W ER2 K",
    "pencil": "P EH1 N S AH0 L",
    "eraser": "IH0 R EY1 S ER0",
    "analysis": "AH0 N AE1 L AH0 S AH0 S",
    "basis": "B EY1 S AH0 S",
    "crisis": "K R AY1 S AH0 S",
    "diagnosis": "D AY2 AH0 G N OW1 S AH0 S",
    "emphasis": "EH1 M F AH0 S IH0 S",
    "thesis": "TH IY1 S IH0 S",
    "parenthesis": "P ER0 EH1 N TH AH0 S AH0 S",
    "oasis": "OW0 EY1 S AH0 S",
    "erect": "IH0 R EH1 K T", "erode": "IH0 R OW1 D",
    "erupt": "IH0 R AH1 P T",
    "erosion": "IH0 R OW1 ZH AH0 N",
    "sediment": "S EH1 D AH0 M AH0 N T",
    "compliment": "K AA1 M P L AH0 M AH0 N T",
    "regiment": "R EH1 JH AH0 M AH0 N T",
    "council": "K AW1 N S AH0 L",
    "utensil": "Y UW0 T EH1 N S AH0 L",
    "alcohol": "AE1 L K AH0 HH AA2 L",
    "alphabet": "AE1 L F AH0 B EH2 T",
    "album": "AE1 L B AH0 M",
    "altitude": "AE1 L T AH0 T UW2 D",
    "always": "AO1 L W EY2 Z",
    "homesick": "HH OW1 M S IH2 K",
    "hometown": "HH OW1 M T AW2 N",
    "homeless": "HH OW1 M L AH0 S",
    "careless": "K EH1 R L AH0 S",
    "hopeless": "HH OW1 P L AH0 S",
    "homepage": "HH OW1 M P EY2 JH",
    "region": "R IY1 JH AH0 N",
    "useless": "Y UW1 S L AH0 S",
    # medicine/health band (twenty-seventh probe, 8/18 blind before
    # the -ache/-jur-/-ulance rules and the destress exceptions)
    "surgery": "S ER1 JH ER0 IY0",
    "headache": "HH EH1 D EY2 K",
    "toothache": "T UW1 TH EY2 K",
    "fever": "F IY1 V ER0",
    "injury": "IH1 N JH ER0 IY0",
    "bandage": "B AE1 N D AH0 JH",
    "vaccine": "V AE0 K S IY1 N",
    "pharmacy": "F AA1 R M AH0 S IY0",
    "prescription": "P R AH0 S K R IH1 P SH AH0 N",
    "allergy": "AE1 L ER0 JH IY0",
    "symptom": "S IH1 M P T AH0 M",
    "nurse": "N ER1 S",
    "ambulance": "AE1 M B Y AH0 L AH0 N S",
    "emergency": "IH0 M ER1 JH AH0 N S IY0",
    "infection": "IH0 N F EH1 K SH AH0 N",
    "vitamin": "V AY1 T AH0 M AH0 N",
    "appetite": "AE1 P AH0 T AY2 T",
    "injection": "IH0 N JH EH1 K SH AH0 N",
    "therapy": "TH EH1 R AH0 P IY0",
    "therapist": "TH EH1 R AH0 P IH0 S T",
    "alley": "AE1 L IY0",
    "distance": "D IH1 S T AH0 N S",
    "emerge": "IH0 M ER1 JH",
    "conjure": "K AA1 N JH ER0",
    "perjury": "P ER1 JH ER0 IY0",
    # emotions/personality band (twenty-eighth probe, 9/12 blind
    # before the -ageous/-cere/-ierce rules)
    "furious": "F Y UH1 R IY0 AH0 S",
    "selfish": "S EH1 L F IH0 SH",
    "stubborn": "S T AH1 B ER0 N",
    "humble": "HH AH1 M B AH0 L",
    "cheerful": "CH IH1 R F AH0 L",
    "miserable": "M IH1 Z ER0 AH0 B AH0 L",
    "gloomy": "G L UW1 M IY0",
    "courageous": "K ER0 EY1 JH AH0 S",
    "sincere": "S IH0 N S IH1 R",
    "loyal": "L OY1 AH0 L",
    "gentle": "JH EH1 N T AH0 L",
    "fierce": "F IH1 R S",
    "pierce": "P IH1 R S",
    "outrageous": "AW0 T R EY1 JH AH0 S",
    # technology/internet band (twenty-ninth probe, 7/14 blind before
    # the password/wire/update/browse/-enna fixes)
    "website": "W EH1 B S AY2 T",
    "download": "D AW1 N L OW2 D",
    "upload": "AH1 P L OW2 D",
    "password": "P AE1 S W ER2 D",
    "screen": "S K R IY1 N",
    "battery": "B AE1 T ER0 IY0",
    "charger": "CH AA1 R JH ER0",
    "wireless": "W AY1 R L AH0 S",
    "folder": "F OW1 L D ER0",
    "virus": "V AY1 R AH0 S",
    "update": "AH1 P D EY2 T",
    "digital": "D IH1 JH AH0 T AH0 L",
    "browser": "B R AW1 Z ER0",
    "bluetooth": "B L UW1 T UW2 TH",
    "antenna": "AE0 N T EH1 N AH0",
    "wire": "W AY1 ER0",
    # house/kitchen band (thirtieth probe, 11/17 blind before the
    # drawer/cushion/-erator/-washer/vacuum/sponge fixes)
    "drawer": "D R AO1 R",
    "shelf": "SH EH1 L F",
    "cushion": "K UH1 SH AH0 N",
    "blanket": "B L AE1 NG K AH0 T",
    "pillow": "P IH1 L OW0",
    "mattress": "M AE1 T R AH0 S",
    "faucet": "F AO1 S AH0 T",
    "refrigerator": "R IH0 F R IH1 JH ER0 EY2 T ER0",
    "generator": "JH EH1 N ER0 EY2 T ER0",
    "dishwasher": "D IH1 SH W AA2 SH ER0",
    "vacuum": "V AE1 K Y UW0 M",
    "broom": "B R UW1 M",
    "bucket": "B AH1 K AH0 T",
    "sponge": "S P AH1 N JH",
    "detergent": "D IH0 T ER1 JH AH0 N T",
    "hammer": "HH AE1 M ER0",
    "ladder": "L AE1 D ER0",
    "laundry": "L AO1 N D R IY0",
    # government/politics band (thirty-first probe, 10/19 blind
    # before the -icy/-ulation/-itut- rules and the pins)
    "citizen": "S IH1 T AH0 Z AH0 N",
    "democracy": "D IH0 M AA1 K R AH0 S IY0",
    "senator": "S EH1 N AH0 T ER0",
    "governor": "G AH1 V ER0 N ER0",
    "mayor": "M EY1 ER0",
    "policy": "P AA1 L AH0 S IY0",
    "debate": "D IH0 B EY1 T",
    "protest": "P R OW1 T EH2 S T",
    "freedom": "F R IY1 D AH0 M",
    "equality": "IH0 K W AA1 L AH0 T IY0",
    "equal": "IY1 K W AH0 L",
    "community": "K AH0 M Y UW1 N AH0 T IY0",
    "population": "P AA2 P Y AH0 L EY1 SH AH0 N",
    "immigrant": "IH1 M AH0 G R AH0 N T",
    "immigration": "IH2 M AH0 G R EY1 SH AH0 N",
    "refugee": "R EH2 F Y UW0 JH IY1",
    "border": "B AO1 R D ER0",
    "treaty": "T R IY1 T IY0",
    "constitution": "K AA2 N S T AH0 T UW1 SH AH0 N",
    "liberty": "L IH1 B ER0 T IY0",
    "congress": "K AA1 NG G R AH0 S",
    # verbs/abstract band (thirty-second probe, 9/18 blind before the
    # -ciate/-tiate/sua fixes and the deep-irregular pins)
    "persuade": "P ER0 S W EY1 D",
    "recommend": "R EH2 K AH0 M EH1 N D",
    "describe": "D IH0 S K R AY1 B",
    "criticize": "K R IH1 T IH0 S AY2 Z",
    "apologize": "AH0 P AA1 L AH0 JH AY2 Z",
    "exaggerate": "IH0 G Z AE1 G ER0 EY2 T",
    "hesitate": "HH EH1 Z IH0 T EY2 T",
    "interrupt": "IH2 N T ER0 AH1 P T",
    "negotiate": "N IH0 G OW1 SH IY0 EY2 T",
    "sacrifice": "S AE1 K R AH0 F AY2 S",
    "threaten": "TH R EH1 T AH0 N",
    "volunteer": "V AA2 L AH0 N T IH1 R",
    "anticipate": "AE0 N T IH1 S AH0 P EY2 T",
    "appreciate": "AH0 P R IY1 SH IY0 EY2 T",
    "associate": "AH0 S OW1 SH IY0 EY2 T",
    "circumstance": "S ER1 K AH0 M S T AE2 N S",
    "consequence": "K AA1 N S AH0 K W AH0 N S",
    "opportunity": "AA2 P ER0 T UW1 N AH0 T IY0",
    "responsibility": "R IH0 S P AA2 N S AH0 B IH1 L AH0 T IY0",
    "responsible": "R IH0 S P AA1 N S AH0 B AH0 L",
    # round-5 thirty-fifth probe band (band A): everyday
    # Latinate/suffix vocabulary behind the new -ism/-asm/-mony/
    # -ere/-archy/-osity/-osure/-osal/-oval/-ival/-ure rule
    # families (tools/g2p_cv.py + band analysis)
    "adhere": "AH0 D HH IH1 R",
    "alimony": "AE1 L AH0 M OW2 N IY0",
    "animosity": "AE2 N AH0 M AA1 S AH0 T IY0",
    "approval": "AH0 P R UW1 V AH0 L",
    "authority": "AH0 TH AO1 R AH0 T IY0",
    "capacity": "K AH0 P AE1 S AH0 T IY0",
    "capture": "K AE1 P CH ER0",
    "carnival": "K AA1 R N AH0 V AH0 L",
    "celebrity": "S AH0 L EH1 B R IH0 T IY0",
    "charity": "CH EH1 R AH0 T IY0",
    "clarity": "K L EH1 R AH0 T IY0",
    "closure": "K L OW1 ZH ER0",
    "collision": "K AH0 L IH1 ZH AH0 N",
    "conclusion": "K AH0 N K L UW1 ZH AH0 N",
    "confusion": "K AH0 N F Y UW1 ZH AH0 N",
    "creature": "K R IY1 CH ER0",
    "criticism": "K R IH1 T IH0 S IH2 Z AH0 M",
    "difficulty": "D IH1 F AH0 K AH0 L T IY0",
    "dignity": "D IH1 G N AH0 T IY0",
    "disposal": "D IH0 S P OW1 Z AH0 L",
    "explosion": "IH0 K S P L OW1 ZH AH0 N",
    "exposure": "IH0 K S P OW1 ZH ER0",
    "faculty": "F AE1 K AH0 L T IY0",
    "failure": "F EY1 L Y ER0",
    "feature": "F IY1 CH ER0",
    "festival": "F EH1 S T AH0 V AH0 L",
    "fixture": "F IH1 K S CH ER0",
    "fracture": "F R AE1 K CH ER0",
    "frustration": "F R AH0 S T R EY1 SH AH0 N",
    "generosity": "JH EH2 N ER0 AA1 S AH0 T IY0",
    "gesture": "JH EH1 S CH ER0",
    "hemisphere": "HH EH1 M AH0 S F IH2 R",
    "illusion": "IH0 L UW1 ZH AH0 N",
    "interfere": "IH2 N T ER0 F IH1 R",
    "interval": "IH1 N T ER0 V AH0 L",
    "invasion": "IH0 N V EY1 ZH AH0 N",
    "journalism": "JH ER1 N AH0 L IH2 Z AH0 M",
    "leisure": "L IY1 ZH ER0",
    "loyalty": "L OY1 AH0 L T IY0",
    "majority": "M AH0 JH AO1 R AH0 T IY0",
    "matrimony": "M AE1 T R AH0 M OW2 N IY0",
    "maturity": "M AH0 CH UH1 R AH0 T IY0",
    "minority": "M AY0 N AO1 R AH0 T IY0",
    "mixture": "M IH1 K S CH ER0",
    "moisture": "M OY1 S CH ER0",
    "monarchy": "M AA1 N AA0 R K IY0",
    "nurture": "N ER1 CH ER0",
    "oligarchy": "AA1 L AH0 G AA2 R K IY0",
    "optimism": "AA1 P T AH0 M IH2 Z AH0 M",
    "organism": "AO1 R G AH0 N IH2 Z AH0 M",
    "pasture": "P AE1 S CH ER0",
    "persuasion": "P ER0 S W EY1 ZH AH0 N",
    "posture": "P AA1 S CH ER0",
    "poverty": "P AA1 V ER0 T IY0",
    "pressure": "P R EH1 SH ER0",
    "priority": "P R AY0 AO1 R AH0 T IY0",
    "procedure": "P R AH0 S IY1 JH ER0",
    "property": "P R AA1 P ER0 T IY0",
    "proposal": "P R AH0 P OW1 Z AH0 L",
    "publicity": "P AH0 B L IH1 S AH0 T IY0",
    "refusal": "R IH0 F Y UW1 Z AH0 L",
    "removal": "R IY0 M UW1 V AH0 L",
    "revision": "R IY0 V IH1 ZH AH0 N",
    "ridicule": "R IH1 D IH0 K Y UW2 L",
    "rupture": "R AH1 P CH ER0",
    "sarcasm": "S AA1 R K AE2 Z AH0 M",
    "sculpture": "S K AH1 L P CH ER0",
    "security": "S IH0 K Y UH1 R AH0 T IY0",
    "seizure": "S IY1 ZH ER0",
    "severe": "S AH0 V IH1 R",
    "survival": "S ER0 V AY1 V AH0 L",
    "testimony": "T EH1 S T AH0 M OW2 N IY0",
    "texture": "T EH1 K S CH ER0",
    "torture": "T AO1 R CH ER0",
    "tourism": "T UH1 R IH2 Z AH0 M",
    "vanity": "V AE1 N AH0 T IY0",
    "variety": "V ER0 AY1 AH0 T IY0",
    "velocity": "V AH0 L AA1 S AH0 T IY0",
    "venture": "V EH1 N CH ER0",
    # round-5 thirty-sixth probe band (band B): domain
    # vocabulary (gardening/astronomy/carpentry/weather/banking/
    # marine/music/sports/chemistry) behind the -ion/-ium/-ogen/
    # -olar/-ometer/-marine/-ling/urr rule families and the
    # final-IH0 coda reduction
    "acoustic": "AH0 K UW1 S T IH0 K",
    "aileron": "EY1 L ER0 AA2 N",
    "annuity": "AH0 N UW1 AH0 T IY0",
    "athletic": "AE0 TH L EH1 T IH0 K",
    "audit": "AO1 D AH0 T",
    "avalanche": "AE1 V AH0 L AE2 N CH",
    "aviator": "EY1 V IY0 EY2 T ER0",
    "bankruptcy": "B AE1 NG K R AH0 P S IY0",
    "biplane": "B AY1 P L EY2 N",
    "collateral": "K AH0 L AE1 T ER0 AH0 L",
    "compound": "K AA1 M P AW0 N D",
    "cosmic": "K AA1 Z M IH0 K",
    "crystalline": "K R IH1 S T AH0 L AY2 N",
    "distillation": "D IH2 S T AH0 L EY1 SH AH0 N",
    "ferry": "F EH1 R IY0",
    "fuselage": "F Y UW1 S AH0 L AA2 ZH",
    "gymnastics": "JH IH0 M N AE1 S T IH0 K S",
    "hailstorm": "HH EY1 L S T AO2 R M",
    "inflation": "IH0 N F L EY1 SH AH0 N",
    "isotope": "AY1 S AH0 T OW2 P",
    "javelin": "JH AE1 V AH0 L AH0 N",
    "joinery": "JH OY1 N ER0 IY0",
    "lilac": "L AY1 L AE2 K",
    "navigation": "N AE2 V AH0 G EY1 SH AH0 N",
    "planetary": "P L AE1 N AH0 T EH2 R IY0",
    "polymer": "P AA1 L AH0 M ER0",
    "reaction": "R IY0 AE1 K SH AH0 N",
    "reef": "R IY1 F",
    "relay": "R IY1 L EY2",
    "rhythmic": "R IH1 DH M IH0 K",
    "sander": "S AE1 N D ER0",
    "saxophone": "S AE1 K S AH0 F OW2 N",
    "serenade": "S EH2 R AH0 N EY1 D",
    "shrub": "SH R AH1 B",
    "solution": "S AH0 L UW1 SH AH0 N",
    "sprint": "S P R IH1 N T",
    "submarine": "S AH2 B M ER0 IY1 N",
    "supernova": "S UW2 P ER0 N OW1 V AH0",
    "taxiing": "T AE1 K S IY0 IH0 NG",
    "tournaments": "T AO1 R N AH0 M AH0 N T S",
    "trowel": "T R AW1 AH0 L",
    "umpire": "AH1 M P AY2 ER0",
    "vessel": "V EH1 S AH0 L",
    "voyage": "V OY1 AH0 JH",
    "wrestling": "R EH1 S AH0 L IH0 NG",
    # round-5 thirty-seventh probe bands (C: second domain sweep,
    # D: basic everyday nouns doubling as compound elements) —
    # behind the -ane/-yme/-yte/electr- rules, the 3-letter
    # compound first-element set, and loan pins
    "aerodynamic": "EH2 R OW0 D AY0 N AE1 M IH0 K",
    "airfield": "EH1 R F IY2 L D",
    "altimeter": "AE0 L T IH1 M AH0 T ER0",
    "ammonia": "AH0 M OW1 N Y AH0",
    "anthem": "AE1 N TH AH0 M",
    "archery": "AA1 R CH ER0 IY0",
    "ballad": "B AE1 L AH0 D",
    "bark": "B AA1 R K",
    "barn": "B AA1 R N",
    "beam": "B IY1 M",
    "bench": "B EH1 N CH",
    "bird": "B ER1 D",
    "bite": "B AY1 T",
    "boat": "B OW1 T",
    "bottom": "B AA1 T AH0 M",
    "branch": "B R AE1 N CH",
    "brick": "B R IH1 K",
    "brush": "B R AH1 SH",
    "butter": "B AH1 T ER0",
    "cabin": "K AE1 B AH0 N",
    "cashier": "K AE0 SH IH1 R",
    "cave": "K EY1 V",
    "celestial": "S AH0 L EH1 S CH AH0 L",
    "checking": "CH EH1 K IH0 NG",
    "cheese": "CH IY1 Z",
    "chill": "CH IH1 L",
    "chloride": "K L AO1 R AY0 D",
    "clay": "K L EY1",
    "cliff": "K L IH1 F",
    "cloud": "K L AW1 D",
    "coal": "K OW1 L",
    "combustion": "K AH0 M B AH1 S CH AH0 N",
    "concerto": "K AH0 N CH EH1 R T OW0",
    "copilot": "K OW1 P AY2 L AH0 T",
    "corn": "K AO1 R N",
    "corner": "K AO1 R N ER0",
    "cosmos": "K AA1 Z M OW0 S",
    "creditor": "K R EH1 D IH0 T ER0",
    "creek": "K R IY1 K",
    "crew": "K R UW1",
    "crop": "K R AA1 P",
    "cup": "K AH1 P",
    "debtor": "D EH1 T ER0",
    "decathlon": "D IH0 K AE1 TH L AA0 N",
    "deck": "D EH1 K",
    "dew": "D UW1",
    "dish": "D IH1 SH",
    "dock": "D AA1 K",
    "drummer": "D R AH1 M ER0",
    "dugout": "D AH1 G AW2 T",
    "dust": "D AH1 S T",
    "edge": "EH1 JH",
    "electrode": "IH0 L EH1 K T R OW0 D",
    "ensemble": "AA0 N S AA1 M B AH0 L",
    "enzyme": "EH1 N Z AY2 M",
    "equinox": "IY1 K W AH0 N AA2 K S",
    "evaporation": "IH0 V AE2 P ER0 EY1 SH AH0 N",
    "fare": "F EH1 R",
    "fence": "F EH1 N S",
    "fencing": "F EH1 N S IH0 NG",
    "fern": "F ER1 N",
    "field": "F IY1 L D",
    "flame": "F L EY1 M",
    "flotilla": "F L OW0 T IH1 L AH0",
    "flour": "F L AW1 ER0",
    "fog": "F AA1 G",
    "fork": "F AO1 R K",
    "gate": "G EY1 T",
    "gaze": "G EY1 Z",
    "germinate": "JH ER1 M AH0 N EY2 T",
    "glucose": "G L UW1 K OW0 S",
    "glue": "G L UW1",
    "goal": "G OW1 L",
    "grass": "G R AE1 S",
    "gravitational": "G R AE2 V AH0 T EY1 SH AH0 N AH0 L",
    "harpoon": "HH AA0 R P UW1 N",
    "hay": "HH EY1",
    "heat": "HH IY1 T",
    "heatwave": "HH IY1 T W EY2 V",
    "hole": "HH OW1 L",
    "horse": "HH AO1 R S",
    "horticulture": "HH AO1 R T IH0 K AH2 L CH ER0",
    "hurdles": "HH ER1 D AH0 L Z",
    "ice": "AY1 S",
    "innings": "IH1 N IH0 NG Z",
    "interstellar": "IH2 N T ER0 S T EH1 L ER0",
    "jet": "JH EH1 T",
    "jetliner": "JH EH1 T L AY2 N ER0",
    "joist": "JH OY1 S T",
    "knife": "N AY1 F",
    "lake": "L EY1 K",
    "landing": "L AE1 N D IH0 NG",
    "leaf": "L IY1 F",
    "maestro": "M AY1 S T R OW0",
    "mallet": "M AE1 L AH0 T",
    "mariner": "M EH1 R AH0 N ER0",
    "mast": "M AE1 S T",
    "meadow": "M EH1 D OW2",
    "methane": "M EH1 TH EY0 N",
    "middle": "M IH1 D AH0 L",
    "mill": "M IH1 L",
    "mist": "M IH1 S T",
    "moon": "M UW1 N",
    "moss": "M AO1 S",
    "nautical": "N AO1 T IH0 K AH0 L",
    "off": "AO1 F",
    "offside": "AO1 F S AY2 D",
    "overture": "OW1 V ER0 CH ER0",
    "paddle": "P AE1 D AH0 L",
    "pan": "P AE1 N",
    "path": "P AE1 TH",
    "peroxide": "P ER0 AA1 K S AY0 D",
    "pier": "P IH1 R",
    "pipe": "P AY1 P",
    "planetarium": "P L AE2 N AH0 T EH1 R IY0 AH0 M",
    "pollen": "P AA1 L AH0 N",
    "pollinate": "P AA1 L AH0 N EY2 T",
    "pond": "P AA1 N D",
    "porthole": "P AO1 R T HH OW2 L",
    "pot": "P AA1 T",
    "quarterback": "K W AO1 R T ER0 B AE2 K",
    "quasar": "K W EY1 Z AA0 R",
    "rafter": "R AE1 F T ER0",
    "rain": "R EY1 N",
    "refinance": "R IY0 F AY1 N AE2 N S",
    "ridge": "R IH1 JH",
    "rock": "R AA1 K",
    "roof": "R UW1 F",
    "root": "R UW1 T",
    "rope": "R OW1 P",
    "sail": "S EY1 L",
    "salt": "S AO1 L T",
    "sand": "S AE1 N D",
    "sapling": "S AE1 P L IH0 NG",
    "saw": "S AO1",
    "sawhorse": "S AO1 HH AO2 R S",
    "sawmill": "S AO1 M IH2 L",
    "score": "S K AO1 R",
    "sea": "S IY1",
    "seafarer": "S IY1 F EH2 R ER0",
    "seed": "S IY1 D",
    "shadow": "SH AE1 D OW2",
    "shed": "SH EH1 D",
    "shore": "SH AO1 R",
    "silk": "S IH1 L K",
    "sky": "S K AY1",
    "slope": "S L OW1 P",
    "smoke": "S M OW1 K",
    "snow": "S N OW1",
    "solstice": "S AA1 L S T AH0 S",
    "spark": "S P AA1 R K",
    "spoon": "S P UW1 N",
    "stargazer": "S T AA1 R G EY2 Z ER0",
    "statement": "S T EY1 T M AH0 N T",
    "steel": "S T IY1 L",
    "stem": "S T EH1 M",
    "storm": "S T AO1 R M",
    "sulfur": "S AH1 L F ER0",
    "sun": "S AH1 N",
    "swamp": "S W AA1 M P",
    "takeoff": "T EY1 K AO2 F",
    "tape": "T EY1 P",
    "temperate": "T EH1 M P ER0 AH0 T",
    "thorn": "TH AO1 R N",
    "tidal": "T AY1 D AH0 L",
    "tool": "T UW1 L",
    "topsoil": "T AA1 P S OY2 L",
    "trail": "T R EY1 L",
    "transfer": "T R AE1 N S F ER0",
    "tree": "T R IY1",
    "trunk": "T R AH1 NG K",
    "turbine": "T ER1 B AY0 N",
    "vault": "V AO1 L T",
    "vine": "V AY1 N",
    "vocalist": "V OW1 K AH0 L IH0 S T",
    "wall": "W AO1 L",
    "wave": "W EY1 V",
    "wharf": "W AO1 R F",
    "wheat": "W IY1 T",
    "wind": "W IH1 N D",
    "windchill": "W IH1 N D CH IH2 L",
    "woodwork": "W UH1 D W ER2 K",
    "wool": "W UH1 L",
    "zodiac": "Z OW1 D IY0 AE2 K",
    # round-5 band F: basic nouns/verbs closing band-E compound
    # element gaps
    "bat": "B AE1 T",
    "bed": "B EH1 D",
    "blade": "B L EY1 D",
    "bow": "B OW1",
    "box": "B AA1 K S",
    "camp": "K AE1 M P",
    "catch": "K AE1 CH",
    "cross": "K R AO1 S",
    "crow": "K R OW1",
    "dial": "D AY1 AH0 L",
    "dig": "D IH1 G",
    "dive": "D AY1 V",
    "drum": "D R AH1 M",
    "fire": "F AY1 ER0",
    "flake": "F L EY1 K",
    "gear": "G IH1 R",
    "golf": "G AA1 L F",
    "helm": "HH EH1 L M",
    "hike": "HH AY1 K",
    "hunt": "HH AH1 N T",
    "jog": "JH AA1 G",
    "jump": "JH AH1 M P",
    "lime": "L AY1 M",
    "log": "L AO1 G",
    "mile": "M AY1 L",
    "mine": "M AY1 N",
    "oar": "AO1 R",
    "pave": "P EY1 V",
    "pile": "P AY1 L",
    "pitch": "P IH1 CH",
    "proof": "P R UW1 F",
    "raft": "R AE1 F T",
    "row": "R OW1",
    "sale": "S EY1 L",
    "scare": "S K EH1 R",
    "shell": "SH EH1 L",
    "sick": "S IH1 K",
    "skate": "S K EY1 T",
    "ski": "S K IY1",
    "speed": "S P IY1 D",
    "stack": "S T AE1 K",
    "surf": "S ER1 F",
    "swim": "S W IH1 M",
    "tail": "T EY1 L",
    "weed": "W IY1 D",
    "weld": "W EH1 L D",
    "wreck": "R EH1 K",
    # round-5 thirty-eighth probe band (band E): compounds,
    # agentives and gerunds behind the -man/-sman/oar rules, the
    # 3-letter compound-element sets, strip-suffix degemination,
    # and syllabic-le -ing elision
    "airspeed": "EH1 R S P IY2 D",
    "airway": "EH1 R W EY2",
    "batsman": "B AE1 T S M AH0 N",
    "batter": "B AE1 T ER0",
    "bedrock": "B EH1 D R AA2 K",
    "billboard": "B IH1 L B AO2 R D",
    "boulder": "B OW1 L D ER0",
    "bowler": "B OW1 L ER0",
    "bowling": "B OW1 L IH0 NG",
    "boxer": "B AA1 K S ER0",
    "camping": "K AE1 M P IH0 NG",
    "cardboard": "K AA1 R D B AO2 R D",
    "catcher": "K AE1 CH ER0",
    "climber": "K L AY1 M ER0",
    "clipboard": "K L IH1 P B AO2 R D",
    "cornfield": "K AO1 R N F IY2 L D",
    "crosswind": "K R AO1 S W IH2 N D",
    "cycling": "S AY1 K L IH0 NG",
    "daylight": "D EY1 L AY2 T",
    "digger": "D IH1 G ER0",
    "diving": "D AY1 V IH0 NG",
    "drilling": "D R IH1 L IH0 NG",
    "farmhouse": "F AA1 R M HH AW2 S",
    "fireproof": "F AY1 ER0 P R UW2 F",
    "firewood": "F AY1 ER0 W UH2 D",
    "fisherman": "F IH1 SH ER0 M AH0 N",
    "fishing": "F IH1 SH IH0 NG",
    "flagpole": "F L AE1 G P OW2 L",
    "floodlight": "F L AH1 D L AY2 T",
    "flooring": "F L AO1 R IH0 NG",
    "gardener": "G AA1 R D AH0 N ER0",
    "gearbox": "G IH1 R B AA2 K S",
    "golfer": "G AA1 L F ER0",
    "gravel": "G R AE1 V AH0 L",
    "grindstone": "G R AY1 N D S T OW2 N",
    "harvester": "HH AA1 R V AH0 S T ER0",
    "haystack": "HH EY1 S T AE2 K",
    "headwind": "HH EH1 D W IH2 N D",
    "helmsman": "HH EH1 L M Z M AH0 N",
    "hiking": "HH AY1 K IH0 NG",
    "hunting": "HH AH1 N T IH0 NG",
    "jogging": "JH AA1 G IH0 NG",
    "jumper": "JH AH1 M P ER0",
    "kayak": "K AY1 AE2 K",
    "keystone": "K IY1 S T OW2 N",
    "lifeboat": "L AY1 F B OW2 T",
    "limestone": "L AY1 M S T OW2 N",
    "logging": "L AO1 G IH0 NG",
    "mail": "M EY1 L",
    "mailbox": "M EY1 L B AA2 K S",
    "milestone": "M AY1 L S T OW2 N",
    "mining": "M AY1 N IH0 NG",
    "moonlight": "M UW1 N L AY2 T",
    "oarsman": "AO1 R Z M AH0 N",
    "oatmeal": "OW1 T M IY2 L",
    "paddling": "P AE1 D L IH0 NG",
    "paneling": "P AE1 N AH0 L IH0 NG",
    "paving": "P EY1 V IH0 NG",
    "pebble": "P EH1 B AH0 L",
    "pitcher": "P IH1 CH ER0",
    "planter": "P L AE1 N T ER0",
    "plumbing": "P L AH1 M IH0 NG",
    "quarry": "K W AO1 R IY0",
    "rafting": "R AE1 F T IH0 NG",
    "rainbow": "R EY1 N B OW2",
    "raincoat": "R EY1 N K OW2 T",
    "rainfall": "R EY1 N F AO2 L",
    "roofing": "R UW1 F IH0 NG",
    "rowboat": "R OW1 B OW2 T",
    "rower": "R OW1 ER0",
    "rowing": "R OW1 IH0 NG",
    "runner": "R AH1 N ER0",
    "sailboat": "S EY1 L B OW2 T",
    "sailing": "S EY1 L IH0 NG",
    "sandbox": "S AE1 N D B AA2 K S",
    "sandstone": "S AE1 N D S T OW2 N",
    "sawblade": "S AO1 B L EY2 D",
    "scaffolding": "S K AE1 F AH0 L D IH0 NG",
    "scarecrow": "S K EH1 R K R OW2",
    "seaplane": "S IY1 P L EY2 N",
    "seashell": "S IY1 SH EH2 L",
    "seashore": "S IY1 SH AO2 R",
    "seasick": "S IY1 S IH2 K",
    "shipwreck": "SH IH1 P R EH2 K",
    "skater": "S K EY1 T ER0",
    "skier": "S K IY1 ER0",
    "skiing": "S K IY1 IH0 NG",
    "snowfall": "S N OW1 F AO2 L",
    "snowflake": "S N OW1 F L EY2 K",
    "snowstorm": "S N OW1 S T AO2 R M",
    "soundproof": "S AW1 N D P R UW2 F",
    "spotlight": "S P AA1 T L AY2 T",
    "steamship": "S T IY1 M SH IH2 P",
    "stopwatch": "S T AA1 P W AA2 CH",
    "sundial": "S AH1 N D AY2 AH0 L",
    "sunrise": "S AH1 N R AY2 Z",
    "sunset": "S AH1 N S EH2 T",
    "surfer": "S ER1 F ER0",
    "surfing": "S ER1 F IH0 NG",
    "tailwind": "T EY1 L W IH2 N D",
    "toolbox": "T UW1 L B AA2 K S",
    "tugboat": "T AH1 G B OW2 T",
    "waterfall": "W AO1 T ER0 F AO2 L",
    "watermill": "W AO1 T ER0 M IH2 L",
    "waterproof": "W AO1 T ER0 P R UW2 F",
    "weeder": "W IY1 D ER0",
    "welder": "W EH1 L D ER0",
    "welding": "W EH1 L D IH0 NG",
    "whetstone": "W EH1 T S T OW2 N",
    "windmill": "W IH1 N D M IH2 L",
    "woodpile": "W UH1 D P AY2 L",
    "wristwatch": "R IH1 S T W AA2 CH",
    # round-5 thirty-ninth probe band (band G): inflections,
    # instruments, chemical elements, -ular adjectives — behind
    # the ular/alc/tz/ygen/oar/n-sure rules and with- destress
    "accordion": "AH0 K AO1 R D IY0 AH0 N",
    "aluminum": "AH0 L UW1 M AH0 N AH0 M",
    "banjo": "B AE1 N JH OW0",
    "binocular": "B AH0 N AA1 K Y AH0 L ER0",
    "bronze": "B R AA1 N Z",
    "calcium": "K AE1 L S IY0 AH0 M",
    "carbon": "K AA1 R B AH0 N",
    "cello": "CH EH1 L OW0",
    "cellular": "S EH1 L Y AH0 L ER0",
    "chords": "K AO1 R D Z",
    "circular": "S ER1 K Y AH0 L ER0",
    "conducted": "K AH0 N D AH1 K T IH0 D",
    "copper": "K AA1 P ER0",
    "docking": "D AA1 K IH0 NG",
    "drumming": "D R AH1 M IH0 NG",
    "flute": "F L UW1 T",
    "gliding": "G L AY1 D IH0 NG",
    "granite": "G R AE1 N AH0 T",
    "harmonica": "HH AA0 R M AA1 N IH0 K AH0",
    "helium": "HH IY1 L IY0 AH0 M",
    "insured": "IH0 N SH UH1 R D",
    "invested": "IH0 N V EH1 S T IH0 D",
    "magnesium": "M AE0 G N IY1 Z IY0 AH0 M",
    "marble": "M AA1 R B AH0 L",
    "molecular": "M AH0 L EH1 K Y AH0 L ER0",
    "mooring": "M UH1 R IH0 NG",
    "muscular": "M AH1 S K Y AH0 L ER0",
    "oboe": "OW1 B OW0",
    "oxygen": "AA1 K S AH0 JH AH0 N",
    "particular": "P ER0 T IH1 K Y AH0 L ER0",
    "pewter": "P Y UW1 T ER0",
    "planting": "P L AE1 N T IH0 NG",
    "potassium": "P AH0 T AE1 S IY0 AH0 M",
    "pruned": "P R UW1 N D",
    "quartz": "K W AO1 R T S",
    "rectangular": "R EH0 K T AE1 NG G Y AH0 L ER0",
    "rehearsal": "R IH0 HH ER1 S AH0 L",
    "rehearse": "R IH0 HH ER1 S",
    "soaring": "S AO1 R IH0 NG",
    "spectacular": "S P EH0 K T AE1 K Y AH0 L ER0",
    "spectrum": "S P EH1 K T R AH0 M",
    "strumming": "S T R AH1 M IH0 NG",
    "tambourine": "T AE2 M B ER0 IY1 N",
    "triangular": "T R AY0 AE1 NG G Y AH0 L ER0",
    "trombone": "T R AA0 M B OW1 N",
    "tuning": "T UW1 N IH0 NG",
    "vehicular": "V IY0 HH IH1 K Y AH0 L ER0",
    "velvet": "V EH1 L V AH0 T",
    "withdrawn": "W IH0 TH D R AO1 N",
    "xylophone": "Z AY1 L AH0 F OW2 N",
    # round-5 fortieth probe band (band H): participles and
    # weather/marine/aviation adjectives-verbs behind the
    # alm/alv/nge/oor rules
    "anchored": "AE1 NG K ER0 D",
    "ascend": "AH0 S EH1 N D",
    "ascent": "AH0 S EH1 N T",
    "balmy": "B AA1 M IY0",
    "banked": "B AE1 NG K T",
    "breezy": "B R IY1 Z IY0",
    "buoyant": "B OY1 AH0 N T",
    "capsized": "K AE1 P S AY2 Z D",
    "carved": "K AA1 R V D",
    "choppy": "CH AA1 P IY0",
    "cruised": "K R UW1 Z D",
    "descend": "D IH0 S EH1 N D",
    "drafty": "D R AE1 F T IY0",
    "engrave": "IH0 N G R EY1 V",
    "engraved": "IH0 N G R EY1 V D",
    "forged": "F AO1 R JH D",
    "frost": "F R AO1 S T",
    "frosty": "F R AO1 S T IY0",
    "glazed": "G L EY1 Z D",
    "glide": "G L AY1 D",
    "gusty": "G AH1 S T IY0",
    "hoisted": "HH OY1 S T IH0 D",
    "hover": "HH AH1 V ER0",
    "krill": "K R IH1 L",
    "maneuver": "M AH0 N UW1 V ER0",
    "moored": "M UH1 R D",
    "muggy": "M AH1 G IY0",
    "nautilus": "N AO1 T AH0 L AH0 S",
    "plummet": "P L AH1 M AH0 T",
    "plunge": "P L AH1 N JH",
    "plunged": "P L AH1 N JH D",
    "polished": "P AA1 L IH0 SH T",
    "rusty": "R AH1 S T IY0",
    "salvaged": "S AE1 L V IH0 JH D",
    "skid": "S K IH1 D",
    "slippery": "S L IH1 P ER0 IY0",
    "soared": "S AO1 R D",
    "soggy": "S AA1 G IY0",
    "splintered": "S P L IH1 N T ER0 D",
    "stalled": "S T AO1 L D",
    "stranded": "S T R AE1 N D IH0 D",
    "sturdy": "S T ER1 D IY0",
    "submerged": "S AH0 B M ER1 JH D",
    "swerve": "S W ER1 V",
    "taxi": "T AE1 K S IY0",
    "taxied": "T AE1 K S IY0 D",
    "throttled": "TH R AA1 T AH0 L D",
    "veer": "V IH1 R",
    "warped": "W AO1 R P T",
    # round-5 forty-first probe band (band I): construction/
    # carpentry vocabulary behind the adle/aper/olt/ull/eled rules
    "awning": "AO1 N IH0 NG",
    "bevel": "B EH1 V AH0 L",
    "blunt": "B L AH1 N T",
    "bolt": "B OW1 L T",
    "caulk": "K AO1 K",
    "girder": "G ER1 D ER0",
    "grind": "G R AY1 N D",
    "grout": "G R AW1 T",
    "gutter": "G AH1 T ER0",
    "jagged": "JH AE1 G IH0 D",
    "ladle": "L EY1 D AH0 L",
    "lattice": "L AE1 T AH0 S",
    "louver": "L UW1 V ER0",
    "mortar": "M AO1 R T ER0",
    "plaster": "P L AE1 S T ER0",
    "pulley": "P UH1 L IY0",
    "ragged": "R AE1 G IH0 D",
    "rivet": "R IH1 V AH0 T",
    "rugged": "R AH1 G IH0 D",
    "sealant": "S IY1 L AH0 N T",
    "serrated": "S EH1 R EY2 T IH0 D",
    "sharpen": "SH AA1 R P AH0 N",
    "shingle": "SH IH1 NG G AH0 L",
    "taper": "T EY1 P ER0",
    "wax": "W AE1 K S",
    "winch": "W IH1 N CH",
    # round-5 forty-second probe band (band K): Latinate
    # derivational vocabulary (-ous/-ent/-ancy/-age families; the
    # long stem vowels before -ency/-ancy are lexical)
    "abundant": "AH0 B AH1 N D AH0 N T",
    "acreage": "EY1 K ER0 AH0 JH",
    "adjacent": "AH0 JH EY1 S AH0 N T",
    "agency": "EY1 JH AH0 N S IY0",
    "anchorage": "AE1 NG K ER0 IH0 JH",
    "apparent": "AH0 P EH1 R AH0 N T",
    "buoyancy": "B OY1 AH0 N S IY0",
    "coherent": "K OW0 HH IH1 R AH0 N T",
    "decency": "D IY1 S AH0 N S IY0",
    "drainage": "D R EY1 N AH0 JH",
    "efficient": "IH0 F IH1 SH AH0 N T",
    "fibrous": "F AY1 B R AH0 S",
    "fluency": "F L UW1 AH0 N S IY0",
    "foliage": "F OW1 L IH0 JH",
    "frequency": "F R IY1 K W AH0 N S IY0",
    "hazardous": "HH AE1 Z ER0 D AH0 S",
    "leakage": "L IY1 K AH0 JH",
    "luminous": "L UW1 M AH0 N AH0 S",
    "moorings": "M UH1 R IH0 NG Z",
    "numerous": "N UW1 M ER0 AH0 S",
    "ominous": "AA1 M AH0 N AH0 S",
    "porous": "P AO1 R AH0 S",
    "potency": "P OW1 T AH0 N S IY0",
    "proficient": "P R AH0 F IH1 SH AH0 N T",
    "redundant": "R IH0 D AH1 N D AH0 N T",
    "reluctant": "R IH0 L AH1 K T AH0 N T",
    "resilient": "R IH0 Z IH1 L Y AH0 N T",
    "rigorous": "R IH1 G ER0 AH0 S",
    "salinity": "S AH0 L IH1 N AH0 T IY0",
    "sewage": "S UW1 AH0 JH",
    "shrinkage": "SH R IH1 NG K AH0 JH",
    "spillage": "S P IH1 L AH0 JH",
    "tendency": "T EH1 N D AH0 N S IY0",
    "tonnage": "T AH1 N AH0 JH",
    "transparent": "T R AE0 N S P EH1 R AH0 N T",
    "turbulent": "T ER1 B Y AH0 L AH0 N T",
    "urgency": "ER1 JH AH0 N S IY0",
    "vacancy": "V EY1 K AH0 N S IY0",
    "venomous": "V EH1 N AH0 M AH0 S",
    "vibrancy": "V AY1 B R AH0 N S IY0",
    "vigilance": "V IH1 JH AH0 L AH0 N S",
    "vigorous": "V IH1 G ER0 AH0 S",
    "voltage": "V OW1 L T AH0 JH",
    "wreckage": "R EH1 K AH0 JH",
    # forty-sixth probe band (band N): medicine, theater, insects,
    # baking — plus the bare roots (turn, hang, shorten) whose absence
    # broke compound/suffix splitting (turnover, hangover, shortening)
    "antiseptic": "AE2 N T AH0 S EH1 P T IH0 K",
    "audition": "AO0 D IH1 SH AH0 N",
    "civil": "S IH1 V AH0 L",
    "devil": "D EH1 V AH0 L",
    # band P lexical irregulars behind the -ify/-acy/-escent/-ology
    # families
    "attribute": "AE1 T R AH0 B Y UW2 T",
    "aristocracy": "EH2 R AH0 S T AA1 K R AH0 S IY0",
    "albeit": "AO0 L B IY1 IH0 T",
    # round-5 band Z: -ant/-ent/-ate adjective bases behind the
    # -ancy/-ency/-acy noun derivation (vacancy <- vacant, decency <-
    # decent, privacy <- private: CMU replaces the final T with S IY0)
    "vacant": "V EY1 K AH0 N T",
    "decent": "D IY1 S AH0 N T",
    "vibrant": "V AY1 B R AH0 N T",
    "agent": "EY1 JH AH0 N T",
    "private": "P R AY1 V AH0 T",
    "accurate": "AE1 K Y ER0 AH0 T",
    "frequent": "F R IY1 K W AH0 N T",
    "urgent": "ER1 JH AH0 N T",
    "fluent": "F L UW1 AH0 N T",
    "delicate": "D EH1 L AH0 K AH0 T",
    "intimate": "IH1 N T AH0 M AH0 T",
    "pregnant": "P R EH1 G N AH0 N T",
    "constant": "K AA1 N S T AH0 N T",
    "hesitant": "HH EH1 Z IH0 T AH0 N T",
    "current": "K ER1 AH0 N T",
    "absent": "AE1 B S AH0 N T",
    "recent": "R IY1 S AH0 N T",
    "silent": "S AY1 L AH0 N T",
    "potent": "P OW1 T AH0 N T",
    "latent": "L EY1 T AH0 N T",
    # band W: common first names (lexical loan-origin spellings)
    "charlotte": "SH AA1 R L AH0 T",
    "chloe": "K L OW1 IY0",
    "geoffrey": "JH EH1 F R IY0",
    "giovanni": "JH OW0 V AA1 N IY0",
    "graham": "G R EY1 AH0 M",
    "hugh": "HH Y UW1",
    "isaac": "AY1 Z AH0 K",
    "jose": "HH OW0 Z EY1",
    "joseph": "JH OW1 S AH0 F",
    "juan": "W AA1 N",
    "leah": "L IY1 AH0",
    "louis": "L UW1 IH0 S",
    "luigi": "L UW0 IY1 JH IY0",
    "matthew": "M AE1 TH Y UW0",
    "michael": "M AY1 K AH0 L",
    "miguel": "M IH0 G EH1 L",
    "naomi": "N EY0 OW1 M IY0",
    "phoebe": "F IY1 B IY0",
    "rachel": "R EY1 CH AH0 L",
    "sarah": "S EH1 R AH0",
    "sean": "SH AO1 N",
    "sergio": "S EH1 R JH IY0 OW0",
    "sophia": "S OW0 F IY1 AH0",
    "stephen": "S T IY1 V AH0 N",
    "zoe": "Z OW1 IY0",
    # band V: city/state/country proper nouns (purely lexical, as in
    # CMUdict — the rules cannot derive loan-origin spellings)
    "albuquerque": "AE1 L B AH0 K ER2 K IY0",
    "arkansas": "AA1 R K AH0 N S AO2",
    "atlanta": "AE0 T L AE1 N T AH0",
    "beijing": "B EY2 JH IH1 NG",
    "boston": "B AO1 S T AH0 N",
    "cairo": "K AY1 R OW0",
    "chicago": "SH AH0 K AA1 G OW0",
    "connecticut": "K AH0 N EH1 T AH0 K AH0 T",
    "dallas": "D AE1 L AH0 S",
    "houston": "HH Y UW1 S T AH0 N",
    "illinois": "IH2 L AH0 N OY1",
    "miami": "M AY0 AE1 M IY0",
    "michigan": "M IH1 SH IH0 G AH0 N",
    "montreal": "M AA2 N T R IY0 AO1 L",
    "nairobi": "N AY0 R OW1 B IY0",
    "phoenix": "F IY1 N IH0 K S",
    "prague": "P R AA1 G",
    "seattle": "S IY0 AE1 T AH0 L",
    "toronto": "T ER0 AA1 N T OW0",
    "tucson": "T UW1 S AA2 N",
    "vienna": "V IY0 EH1 N AH0",
    "zurich": "Z UH1 R IH0 K",
    "almond": "AA1 M AH0 N D",
    "beret": "B ER0 EY1",
    "cachet": "K AE0 SH EY1",
    "poignant": "P OY1 N Y AH0 N T",
    "rapport": "R AH0 P AO1 R",
    "wreath": "R IY1 TH",
    "aerobics": "ER0 OW1 B IH0 K S",
    "beatific": "B IY2 AH0 T IH1 F IH0 K",
    "calisthenics": "K AE2 L AH0 S TH EH1 N IH0 K S",
    "dumbbell": "D AH1 M B EH2 L",
    "exhibition": "EH2 K S AH0 B IH1 SH AH0 N",
    "final": "F AY1 N AH0 L",
    "date": "D EY1 T",
    "aria": "AA1 R IY0 AH0",
    "centrifuge": "S EH1 N T R AH0 F Y UW2 JH",
    "cumulus": "K Y UW1 M Y AH0 L AH0 S",
    "isobar": "AY1 S OW0 B AA2 R",
    "lacquer": "L AE1 K ER0",
    "mortise": "M AO1 R T AH0 S",
    "pipette": "P AY0 P EH1 T",
    "squall": "S K W AO1 L",
    "rate": "R EY1 T",
    "spoken": "S P OW1 K AH0 N",
    "understood": "AH2 N D ER0 S T UH1 D",
    "livelihood": "L AY1 V L IY0 HH UH2 D",
    "exponent": "EH1 K S P OW2 N AH0 N T",
    "lichen": "L AY1 K AH0 N",
    "limber": "L IH1 M B ER0",
    "monopoly": "M AH0 N AA1 P AH0 L IY0",
    "nutritious": "N UW0 T R IH1 SH AH0 S",
    "oscillate": "AA1 S AH0 L EY2 T",
    "rhizome": "R AY1 Z OW2 M",
    "solder": "S AA1 D ER0",
    "stamina": "S T AE1 M AH0 N AH0",
    "store": "S T AO1 R",
    "subsidy": "S AH1 B S AH0 D IY0",
    "tariff": "T EH1 R AH0 F",
    "bronchitis": "B R AA0 N K AY1 T IH0 S",
    "carcinogenic": "K AA2 R S AH0 N AH0 JH EH1 N IH0 K",
    "photogenic": "F OW2 T AH0 JH EH1 N IH0 K",
    "windward": "W IH1 N D W ER0 D",
    "destitute": "D EH1 S T AH0 T UW2 T",
    "diplomacy": "D IH0 P L OW1 M AH0 S IY0",
    "execute": "EH1 K S AH0 K Y UW2 T",
    "meteorology": "M IY2 T IY0 ER0 AA1 L AH0 JH IY0",
    "persecute": "P ER1 S AH0 K Y UW2 T",
    "privacy": "P R AY1 V AH0 S IY0",
    "prosecute": "P R AA1 S AH0 K Y UW2 T",
    "solidify": "S AH0 L IH1 D AH0 F AY2",
    "supremacy": "S UH0 P R EH1 M AH0 S IY0",
    "capsule": "K AE1 P S AH0 L",
    "caterpillar": "K AE1 T ER0 P IH2 L ER0",
    "centipede": "S EH1 N T AH0 P IY2 D",
    "chrysalis": "K R IH1 S AH0 L IH0 S",
    "cicada": "S IH0 K EY1 D AH0",
    "cinnamon": "S IH1 N AH0 M AH0 N",
    "dosage": "D OW1 S IH0 JH",
    "dragonfly": "D R AE1 G AH0 N F L AY2",
    "ganache": "G AH0 N AA1 SH",
    "gauze": "G AO1 Z",
    "hang": "HH AE1 NG",
    "hornet": "HH AO1 R N IH0 T",
    "inhaler": "IH0 N HH EY1 L ER0",
    "intermission": "IH2 N T ER0 M IH1 SH AH0 N",
    "knead": "N IY1 D",
    "larvae": "L AA1 R V IY0",
    "lozenge": "L AA1 Z AH0 N JH",
    "marquee": "M AA0 R K IY1",
    "matinee": "M AE2 T AH0 N EY1",
    "meringue": "M ER0 AE1 NG",
    "molasses": "M AH0 L AE1 S IH0 Z",
    "ointment": "OY1 N T M AH0 N T",
    "praline": "P R AA1 L IY0 N",
    "premiere": "P R IH0 M IH1 R",
    "salve": "S AE1 V",
    "scenery": "S IY1 N ER0 IY0",
    "shorten": "SH AO1 R T AH0 N",
    "soliloquy": "S AH0 L IH1 L AH0 K W IY0",
    "sourdough": "S AW1 R D OW2",
    "syringe": "S ER0 IH1 N JH",
    "tarantula": "T ER0 AE1 N CH AH0 L AH0",
    "tourniquet": "T ER1 N IH0 K IH0 T",
    "turn": "T ER1 N",
    "turnover": "T ER1 N OW2 V ER0",
    "understudy": "AH1 N D ER0 S T AH2 D IY0",
    "usher": "AH1 SH ER0",
    "weevil": "W IY1 V AH0 L",
    "yeast": "Y IY1 S T",
    # forty-fifth probe band (band M): maritime, finance, astronomy,
    # textiles — lexical irregulars behind the band's new rule
    # families (-ngham, -charg-, upholst-, embroid-, amortiz-)
    "amortize": "AE1 M ER0 T AY2 Z",
    "arbitrage": "AA1 R B AH0 T R AA2 ZH",
    "ballast": "B AE1 L AH0 S T",
    "bowsprit": "B AW1 S P R IH2 T",
    "brocade": "B R OW0 K EY1 D",
    "capstan": "K AE1 P S T AH0 N",
    "chenille": "SH AH0 N IY1 L",
    "escrow": "EH1 S K R OW0",
    "fiduciary": "F AH0 D UW1 SH IY0 EH2 R IY0",
    "galleon": "G AE1 L IY0 AH0 N",
    "gingham": "G IH1 NG AH0 M",
    "herringbone": "HH EH1 R IH0 NG B OW2 N",
    "liquidity": "L IH0 K W IH1 D AH0 T IY0",
    "luminosity": "L UW2 M AH0 N AA1 S AH0 T IY0",
    "maritime": "M EH1 R AH0 T AY2 M",
    "occultation": "AA2 K AH0 L T EY1 SH AH0 N",
    "paisley": "P EY1 Z L IY0",
    "parallax": "P EH1 R AH0 L AE2 K S",
    "perihelion": "P EH2 R AH0 HH IY1 L IY0 AH0 N",
    "presley": "P R EH1 Z L IY0",
    "regatta": "R AH0 G AA1 T AH0",
    "sidereal": "S AY0 D IH1 R IY0 AH0 L",
    "solvency": "S AA1 L V AH0 N S IY0",
    "surcharge": "S ER1 CH AA2 R JH",
    "taffeta": "T AE1 F AH0 T AH0",
    "upholstery": "AH0 P OW1 L S T ER0 IY0",
    # forty-fourth probe band (band L): geology, textiles, law
    # enforcement, photography — lexical irregulars the rules cannot
    # derive (French/Latin loans, silent letters, reshaped stress)
    "aperture": "AE1 P ER0 CH ER0",
    "apron": "EY1 P R AH0 N",
    "bailiff": "B EY1 L AH0 F",
    "basalt": "B AH0 S AO1 L T",
    "basil": "B AE1 Z AH0 L",
    "chiffon": "SH IH0 F AA1 N",
    "contrast": "K AA1 N T R AE0 S T",
    "corduroy": "K AO1 R D ER0 OY2",
    "demeanor": "D IH0 M IY1 N ER0",
    "deputy": "D EH1 P Y AH0 T IY0",
    "geyser": "G AY1 Z ER0",
    "linen": "L IH1 N AH0 N",
    "misdemeanor": "M IH2 S D IH0 M IY1 N ER0",
    "mishap": "M IH1 S HH AE2 P",
    "parole": "P ER0 OW1 L",
    "precinct": "P R IY1 S IH2 NG K T",
    "probation": "P R OW0 B EY1 SH AH0 N",
    "pumice": "P AH1 M AH0 S",
    "sheriff": "SH EH1 R AH0 F",
    "subpoena": "S AH0 P IY1 N AH0",
    "surveillance": "S ER0 V EY1 L AH0 N S",
    "tectonic": "T EH0 K T AA1 N IH0 K",
    "tripod": "T R AY1 P AA2 D",
    "woolen": "W UH1 L AH0 N",
}

_UNITS = "zero one two three four five six seven eight nine".split()
_TEENS = ("ten eleven twelve thirteen fourteen fifteen sixteen "
          "seventeen eighteen nineteen").split()
_TENS = ("twenty thirty forty fifty sixty seventy eighty ninety").split()

_VOWELS = set("aeiouy")
_CONSONANTS = set("bcdfghjklmnpqrstvwxz")
_VOICED = set("bdvgjlmnrwz")
_FRONT = set("eiy")
_SIBILANT = set("scgzxj")
_LONG_U = set("tsrdlzn")

_STRESSABLE = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}

_LETTER_NAMES = {
    "a": "EY1", "b": "B IY1", "c": "S IY1", "d": "D IY1", "e": "IY1",
    "f": "EH1 F", "g": "JH IY1", "h": "EY1 CH", "i": "AY1",
    "j": "JH EY1", "k": "K EY1", "l": "EH1 L", "m": "EH1 M",
    "n": "EH1 N", "o": "OW1", "p": "P IY1", "q": "K Y UW1",
    "r": "AA1 R", "s": "EH1 S", "t": "T IY1", "u": "Y UW1",
    "v": "V IY1", "w": "D AH1 B AH0 L Y UW0", "x": "EH1 K S",
    "y": "W AY1", "z": "Z IY1",
}

# Common compound-part nouns (regular pronunciations). Kept separate
# from the gold _LEXICON (which deliberately collects irregulars and is
# the rules-floor measurement set); merged into the instance lexicon so
# the compound splitter can resolve words like newspaper/toothbrush.
_COMPOUND_PARTS = {
    "news": "N UW1 Z", "paper": "P EY1 P ER0", "straw": "S T R AO1",
    "berry": "B EH1 R IY0", "tooth": "T UW1 TH", "brush": "B R AH1 SH",
    "rain": "R EY1 N", "bell": "B EH1 L", "water": "W AO1 T ER0",
    "fall": "F AO1 L", "fire": "F AY1 ER0", "place": "P L EY1 S",
    "thing": "TH IH1 NG",
    "where": "W EH1 R", "pass": "P AE1 S", "word": "W ER1 D",
    "book": "B UH1 K", "shop": "SH AA1 P", "ball": "B AO1 L",
    "foot": "F UH1 T", "basket": "B AE1 S K AH0 T", "port": "P AO1 R T",
    "plane": "P L EY1 N", "land": "L AE1 N D", "light": "L AY1 T",
    "moon": "M UW1 N", "star": "S T AA1 R", "fish": "F IH1 SH",
    "snow": "S N OW1", "storm": "S T AO1 R M", "break": "B R EY1 K",
    "hail": "HH EY1 L", "dug": "D AH1 G", "pilot": "P AY1 L AH0 T",
    "power": "P AW1 ER0", "low": "L OW1", "slow": "S L OW1",
    "acre": "EY1 K ER0",
    "fast": "F AE1 S T", "week": "W IY1 K", "home": "HH OW1 M",
    "work": "W ER1 K", "class": "K L AE1 S", "mate": "M EY1 T",
    "play": "P L EY1", "ground": "G R AW1 N D", "side": "S AY1 D",
    "walk": "W AO1 K", "door": "D AO1 R", "room": "R UW1 M",
    "wood": "W UH1 D", "yard": "Y AA1 R D", "time": "T AY1 M",
    "table": "T EY1 B AH0 L", "life": "L AY1 F", "board": "B AO1 R D",
    "hand": "HH AE1 N D", "stone": "S T OW1 N",
    "flower": "F L AW1 ER0", "grand": "G R AE1 N D",
    "under": "AH1 N D ER0", "over": "OW1 V ER0", "stand": "S T AE1 N D",
    "come": "K AH1 M", "night": "N AY1 T", "mare": "M EH1 R",
    "back": "B AE1 K", "wall": "W AO1 L", "milk": "M IH1 L K",
    "shake": "SH EY1 K", "flash": "F L AE1 SH", "spoon": "S P UW1 N",
    "ship": "SH IH1 P", "print": "P R IH1 N T",
    "while": "W AY1 L", "quake": "K W EY1 K", "skate": "S K EY1 T",
    "black": "B L AE1 K", "else": "EH1 L S",
    "soft": "S AO1 F T", "hard": "HH AA1 R D", "ware": "W EH1 R",
    "base": "B EY1 S", "line": "L AY1 N",
    "flake": "F L EY1 K", "watch": "W AA1 CH", "mile": "M AY1 L",
    "lime": "L AY1 M", "speed": "S P IY1 D", "chill": "CH IH1 L",
    "wrist": "R IH1 S T", "sand": "S AE1 N D", "tail": "T EY1 L",
    "cross": "K R AO1 S", "gaze": "G EY1 Z", "stream": "S T R IY1 M",
    "wheel": "W IY1 L", "chair": "CH EH1 R", "front": "F R AH1 N T",
    "field": "F IY1 L D", "house": "HH AW1 S", "horse": "HH AO1 R S",
    "bird": "B ER1 D", "sail": "S EY1 L", "boat": "B OW1 T",
    "cuff": "K AH1 F", "finder": "F AY1 N D ER0", "view": "V Y UW1",
    # roots for the stress-neutral prefixes (entangle, enrich,
    # forgive, forsake)
    "act": "AE1 K T", "rich": "R IH1 CH", "list": "L IH1 S T",
    "roll": "R OW1 L", "sake": "S EY1 K", "tangle": "T AE1 NG G AH0 L",
    "trust": "T R AH1 S T", "gulf": "G AH1 L F",
    "title": "T AY1 T AH0 L", "large": "L AA1 R JH",
    "close": "K L OW1 Z", "force": "F AO1 R S", "joy": "JH OY1",
    "gage": "G EY1 JH", "sure": "SH UH1 R", "roach": "R OW1 CH",
    "bid": "B IH1 D", "bark": "B AA1 R K", "lighten": "L AY1 T AH0 N",
    "courage": "K ER1 AH0 JH", "counter": "K AW1 N T ER0",
    "circle": "S ER1 K AH0 L", "compass": "K AH1 M P AH0 S",
    # lexicalized compounds whose parts would mislead the splitter
    "breakfast": "B R EH1 K F AH0 S T",
    "something": "S AH1 M TH IH0 NG",
    "handsome": "HH AE1 N S AH0 M",
    # round-5 final sweep: elements whose absence stranded compounds
    # when the standalone word was CV-folded out (sandbox, dumbbell,
    # dugout, sourdough, everything, seafarer)
    "box": "B AA1 K S", "out": "AW1 T", "dumb": "D AH1 M",
    "air": "EH1 R",
    "dough": "D OW1", "sour": "S AW1 R",
    "sea": "S IY1", "fare": "F EH1 R", "spray": "S P R EY1",
    "state": "S T EY1 T", "gold": "G OW1 L D", "dark": "D AA1 R K",
    "weak": "W IY1 K", "sharp": "SH AA1 R P", "wide": "W AY1 D",
    "wind": "W IH1 N D", "dust": "D AH1 S T", "salt": "S AO1 L T",
    "drift": "D R IH1 F T", "proof": "P R UW1 F",
}

# first parts that subordinate to the second element (understand,
# overcome): the second part keeps primary stress
_SUBORDINATE_FIRST = frozenset({"under", "over", "out", "with", "fore"})
# lexicon words that act as suffixes, not compound heads (comfortable
# is comfort+-able, not a compound); "some" fully destresses (-some)
_NON_SECOND = frozenset({"able"})

# 3-letter nouns that productively head English compounds (see
# _split_compound); deliberately a closed list — excludes openers of
# false splits like car(pet) and man(date)
_SHORT_FIRST = frozenset(
    """sea saw jet air sun sky ice out oil egg tea ear eye leg arm
    gun fog mud log oak bee cow pig hen dog cat fox owl bat net rod
    bed pot pan pie ham ink pen map bag box cap hat wax tar gas day
    war tax toe rib jaw hay dry dug""".split()
)
# ... and 3-letter nouns that productively CLOSE compounds (mailbox,
# sunset, highway); "man" is handled by the -man suffix rule instead
_SHORT_SECOND = frozenset(
    "box set way bow day bag pot pan bar out off".split()
)
_DESTRESSED_SECOND = frozenset({"some"})
# heteronym elements pinned to their compound-noun reading in either
# position (tailwind/crosswind/windchill read the noun W IH1 N D,
# never the verb W AY1 N D)
# proper nouns in the gold lexicon (bands V/W and earlier name/place
# entries). Purely lexical even for CMUdict/g2p_en — excluded from the
# rules-only generalization floor in tests/test_g2p.py, which measures
# how well the LTS rules derive common-noun vocabulary.
PROPER_NOUNS = frozenset("""
    albuquerque arkansas atlanta beijing boston cairo chicago
    connecticut dallas houston illinois miami michigan montreal
    nairobi phoenix prague seattle toronto tucson vienna zurich
    charlotte chloe geoffrey giovanni graham hugh isaac jose joseph
    juan leah louis luigi matthew michael miguel naomi phoebe rachel
    sarah sean sergio sophia stephen zoe
    presley birmingham nottingham buckingham campbell
    """.split())

_COMPOUND_OVERRIDE = {
    "wind": "W IH1 N D",
    # compounds syncopate "every" (everything EH1 V R IY0 TH IH2 NG)
    # even though the standalone word keeps three syllables
    "every": "EH1 V R IY0",
    # -ward reduces as a compound final (windward W IH1 N D W ER0 D,
    # backward) though the standalone noun keeps W AO1 R D
    "ward": "W ER0 D",
}

# 2-letter Latin prefixes that head compounds with a free stem
# (copilot, coworker, biplane, biweekly); the stem must resolve through
# the lexicon so "cover"/"bingo" never split. The blocklist holds free
# stems whose prefixed form is lexically reduced, not a live compound
# (bicycle B AY1 S IH0 K AH0 L, covert, coward).
_PREFIX_FIRST = {"co": "K OW1", "bi": "B AY1"}
_PREFIX_BLOCK_SECOND = frozenset({"cycle", "ward", "vert", "cent"})

# stress-neutral verb prefixes: the root keeps its own primary and the
# prefix reduces (entangle EH0 N T AE1 NG G AH0 L, forgive
# F ER0 G IH1 V, foretell F AO0 R T EH1 L). Gated on the root being a
# lexicon word so engine/energy/forest never split; the blocklists
# hold roots whose prefixed word is initial-stressed anyway (entry,
# forecast) or lexically reshaped (entire, forward).
_NEUTRAL_PREFIXES = (
    ("fore", "F AO0 R",
     frozenset({"cast", "casts", "ground", "head", "most", "front",
                "man", "men", "arm", "arms"})),
    ("for", "F ER0",
     frozenset({"ward", "wards", "tune", "tunes", "mat", "mats",
                "ear", "est", "ester", "um", "ums", "ay", "ays",
                "age", "ages", "ce", "ces", "me", "mer", "ms", "ties",
                "ty", "k", "ks", "t", "ts", "th", "go"})),
    ("en", "EH0 N",
     frozenset({"try", "tries", "trance", "trances", "tire", "tires",
                "sign", "signs", "gine", "gines", "velope",
                "velopes", "tity", "tities", "ergy", "tree", "trees",
                "vy", "d", "ds", "dings", "ding"})),
    ("em", "EH0 M",
     frozenset({"it", "its", "ber", "bers", "pire", "pires", "blem",
                "blems", "inent", "phasis", "peror", "perors",
                "ail", "ails"})),
    # mis- verbs keep the root's primary (mislead M IH0 S L IY1 D,
    # misplace, mistrust); lexically reshaped forms are blocked
    # (mission, missile via their non-word tails never split) —
    # forty-fourth probe band (band L)
    ("mis", "M IH0 S",
     frozenset({"sing", "sings", "er", "ers", "chief", "tress",
                "sive", "ery", "eries"})),
)

_WORD_RX = re.compile(r"[a-z']+|[0-9]+|[^\sa-z0-9']")


def _number_to_words(num: str) -> List[str]:
    """Spell out a non-negative integer (small-scale; digits fall back
    to digit-by-digit for very large values)."""
    n = int(num)
    if n >= 1_000_000_000:
        return [_UNITS[int(d)] for d in num]
    words: List[str] = []

    def under_thousand(k: int) -> List[str]:
        out = []
        if k >= 100:
            out += [_UNITS[k // 100], "hundred"]
            k %= 100
        if k >= 20:
            out.append(_TENS[k // 10 - 2])
            k %= 10
            if k:
                out.append(_UNITS[k])
        elif k >= 10:
            out.append(_TEENS[k - 10])
        elif k > 0 or not out:
            out.append(_UNITS[k])
        return out

    if n >= 1_000_000:
        words += under_thousand(n // 1_000_000) + ["million"]
        n %= 1_000_000
    if n >= 1000:
        words += under_thousand(n // 1000) + ["thousand"]
        n %= 1000
    if n or not words:
        words += under_thousand(n)
    return words


def _year_style(num: str) -> List[str]:
    """g2p_en's normalize_numbers convention for 1000 < n < 3000
    (two-digit pairs: 1984 = nineteen eighty four, 1902 = nineteen oh
    two, 1900 = nineteen hundred, 2007 = two thousand seven)."""
    n = int(num)
    if not 1000 < n < 3000:
        return _number_to_words(num)
    if n == 2000:
        return ["two", "thousand"]
    if 2000 < n < 2010:
        return ["two", "thousand"] + _number_to_words(str(n % 10))
    if n % 100 == 0:
        return _number_to_words(str(n // 100)) + ["hundred"]
    pair = _number_to_words(str(n % 100))
    if n % 100 < 10:
        pair = ["oh"] + pair
    return _number_to_words(str(n // 100)) + pair


_ORDINAL_WORDS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _ordinal_words(num: str) -> List[str]:
    words = _number_to_words(num)
    last = words[-1]
    if last in _ORDINAL_WORDS:
        words[-1] = _ORDINAL_WORDS[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return words


_COMMA_NUM_RX = re.compile(r"([0-9][0-9,]+[0-9])")
_DOLLARS_RX = re.compile(r"\$([0-9.,]*[0-9]+)")
_POUNDS_RX = re.compile(r"£([0-9,]*[0-9]+)")
_DECIMAL_RX = re.compile(r"([0-9]+)\.([0-9]+)")
_ORDINAL_RX = re.compile(r"([0-9]+)(st|nd|rd|th)\b")
_ABBREVIATIONS = {
    "mr": "mister", "mrs": "mrs", "ms": "ms", "dr": "doctor",
    "vs": "versus", "ave": "avenue", "etc": "etcetera",
}
_ABBREV_RX = re.compile(
    r"\b(" + "|".join(_ABBREVIATIONS) + r")\.")


def _expand_dollars(m: "re.Match") -> str:
    # stray separators ("$,0", "$1..5") read as plain digits
    parts = m.group(1).replace(",", "").split(".")
    try:
        dollars = int(parts[0]) if parts[0] else 0
        cents = int(parts[1][:2]) if len(parts) > 1 and parts[1] else 0
    except ValueError:
        return m.group(1)
    d_unit = "dollar" if dollars == 1 else "dollars"
    c_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return f"{dollars} {d_unit}, {cents} {c_unit}"
    if cents:
        return f"{cents} {c_unit}"
    return f"{dollars} {d_unit}"


def _normalize_numbers(text: str) -> str:
    """Mirror g2p_en's normalize_numbers pre-pass (its expand module):
    strip thousand-separators, expand currency, read the decimal point
    as "point", expand ordinal suffixes, and read 1000-3000 in year
    style. The reference pipeline inherits exactly these conventions
    from g2p_en (voice100/text.py:64-71)."""
    text = _COMMA_NUM_RX.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _POUNDS_RX.sub(lambda m: f"{m.group(1)} pounds", text)
    text = _DOLLARS_RX.sub(_expand_dollars, text)
    text = _DECIMAL_RX.sub(lambda m: f"{m.group(1)} point {m.group(2)}",
                           text)
    text = _ORDINAL_RX.sub(
        lambda m: " ".join(_ordinal_words(m.group(1))), text)
    # documented superset of g2p_en: it silently DROPS %/& in its
    # character filter, losing spoken content ("25%" -> "twenty five");
    # expanding them reads the text the way a speaker would
    text = text.replace("%", " percent")
    text = text.replace("&", " and ")
    # title/common abbreviations with their period consumed ("dr."
    # would otherwise spell out as D IY1 AA1 R); g2p_en leaves these
    # unexpanded. "st." stays untouched: saint vs street is ambiguous
    text = _ABBREV_RX.sub(lambda m: _ABBREVIATIONS[m.group(1)], text)
    return text


class G2P:
    """English text -> CMU phone token list.

    Output contract matches ``g2p_en.G2p`` as consumed by the reference
    CMUPhonemizer (voice100/text.py:69-71): per-word phone tokens with a
    ``' '`` token between words, punctuation preserved as tokens.
    """

    def __init__(self, lexicon_path: Optional[str] = None) -> None:
        from . import heteronyms

        self._lexicon = dict(_LEXICON)
        # unambiguous verb inflections of heteronyms ("recorded",
        # "using") resolve to the verb-slot pronunciation
        for form, pron in heteronyms.verb_forms().items():
            self._lexicon.setdefault(form, pron)
        for part, pron in _COMPOUND_PARTS.items():
            self._lexicon.setdefault(part, pron)
        env_path = lexicon_path or os.environ.get("VOICE100_TPU_CMUDICT")
        if env_path and os.path.exists(env_path):
            self._load_cmudict(env_path)
        self._g2p_en = None
        try:  # upgrade to the reference G2P when present
            from g2p_en import G2p  # type: ignore

            self._g2p_en = G2p()
        except Exception:
            pass

    def _load_cmudict(self, path: str) -> None:
        with open(path, encoding="latin-1") as f:
            for line in f:
                if not line or line.startswith(";;;"):
                    continue
                parts = line.split()
                if len(parts) < 2 or "(" in parts[0]:
                    continue
                self._lexicon[parts[0].lower()] = " ".join(parts[1:])

    def __call__(self, text: str) -> List[str]:
        if self._g2p_en is not None:
            return list(self._g2p_en(text))
        tokens = _WORD_RX.findall(_normalize_numbers(text.lower()))
        words: List[str] = []
        for tok in tokens:
            if tok.isdigit():
                words.extend(_year_style(tok))
            else:
                words.append(tok)
        from . import heteronyms

        out: List[str] = []
        for i, word in enumerate(words):
            if i > 0:
                out.append(" ")
            if word[0].isalpha() or word[0] == "'":
                phones = heteronyms.resolve(word, words, i)
                if phones is None:
                    phones = self._word_phones(word)
                out.extend(phones)
            else:
                out.append(word)
        return out

    # irregular high-frequency forms whose spelling misleads every
    # generative path (says is not say+s; titles are vowel-less and
    # would spell out as letter names; number is not numb+er), plus
    # the closed class of adjectival -ed words that keep a syllabic
    # ending where the verb participle would not (a jagged edge vs. he
    # jagged left) and lexicalized syncope (evening, government)
    _IRREGULAR = {
        # really contracts to two syllables (not real+ly), so the
        # suffix stripper must not see it
        "really": "R IH1 L IY0",
        "says": "S EH1 Z", "does": "D AH1 Z", "mr": "M IH1 S T ER0",
        "mrs": "M IH1 S IH0 Z", "ms": "M IH1 Z",
        "number": "N AH1 M B ER0", "numbers": "N AH1 M B ER0 Z",
        "evening": "IY1 V N IH0 NG", "evenings": "IY1 V N IH0 NG Z",
        "government": "G AH1 V ER0 M AH0 N T",
        "governments": "G AH1 V ER0 M AH0 N T S",
        "jagged": "JH AE1 G IH0 D", "ragged": "R AE1 G IH0 D",
        "rugged": "R AH1 G IH0 D", "dogged": "D AO1 G IH0 D",
        "wicked": "W IH1 K AH0 D", "naked": "N EY1 K AH0 D",
        "crooked": "K R UH1 K AH0 D", "wretched": "R EH1 CH AH0 D",
    }

    def _word_phones(self, word: str) -> List[str]:
        if word in self._lexicon:
            return self._lexicon[word].split()
        if word in self._IRREGULAR:
            return self._IRREGULAR[word].split()
        if word in _COMPOUND_PARTS:
            # the parts table holds correct standalone pronunciations
            # (and preempts the splitter for lexicalized compounds
            # like breakfast, whose live parts would mislead it)
            return _COMPOUND_PARTS[word].split()
        # strip morphological suffixes and retry the lexicon, voicing the
        # affix phone by the stem's final sound like g2p_en's dictionary
        # layer would return
        stripped = self._strip_suffix(word)
        if stripped is not None:
            return stripped
        if not any(c in "aeiouy" for c in word):
            # vowel-less letter strings are acronyms: spell them out
            # (tv = T IY1 V IY1) rather than emit a consonant cluster
            out: List[str] = []
            for c in word:
                out.extend(_LETTER_NAMES.get(c, "").split())
            if out:
                return out
        compound = self._split_compound(word)
        if compound is not None:
            return compound
        return self._lts(word)

    def _split_compound(self, word: str) -> Optional[List[str]]:
        """Noun-compound splitting: both halves must resolve through the
        lexicon (second may carry a morphological suffix), each >= 4
        letters — conservative enough that carpet/mandate never split.
        3-letter halves are allowed only from the curated productive
        sets (_SHORT_FIRST/_SHORT_SECOND). Stress: second element
        demoted to secondary (newspaper -> N UW1 Z P EY2 P ER0), or
        the first for subordinating prefixes (understand ->
        AH2 N D ER0 S T AE1 N D)."""
        for i in range(3, len(word) - 2):
            a, b = word[:i], word[i:]
            if len(a) == 3 and a not in _SHORT_FIRST:
                # a blanket 3-letter rule would split carpet (car+pet)
                # and mandate (man+date)
                continue
            if len(b) == 3 and b not in _SHORT_SECOND:
                continue
            # curated parts back the lexicon so a compound still splits
            # when the standalone word is absent (CV folds, trimmed
            # lexicons); heteronym overrides take the noun reading
            pa = (_COMPOUND_OVERRIDE.get(a) or self._lexicon.get(a)
                  or _COMPOUND_PARTS.get(a))
            if pa is None or b in _NON_SECOND:
                continue
            pb = (_COMPOUND_OVERRIDE.get(b) or self._lexicon.get(b)
                  or _COMPOUND_PARTS.get(b))
            pb_phones = (pb.split() if pb is not None
                         else self._strip_suffix(b, _COMPOUND_PARTS))
            if pb_phones is None:
                continue
            first, second = pa.split(), list(pb_phones)

            def demote(phones: List[str], digit: str) -> List[str]:
                return [p[:-1] + digit if p.endswith("1") else p
                        for p in phones]

            if a in _SUBORDINATE_FIRST:
                first = demote(first, "2")
            elif b in _DESTRESSED_SECOND:
                second = demote(second, "0")
            else:
                second = demote(second, "2")
            return first + second
        for pre, pre_phones in _PREFIX_FIRST.items():
            if not word.startswith(pre) or len(word) - len(pre) < 4:
                continue
            b = word[len(pre):]
            if b in _PREFIX_BLOCK_SECOND or b in _NON_SECOND:
                continue
            pb_phones = (self._lexicon[b].split() if b in self._lexicon
                         else self._strip_suffix(b, _COMPOUND_PARTS))
            if pb_phones is None:
                continue
            second = [p[:-1] + "2" if p.endswith("1") else p
                      for p in pb_phones]
            return pre_phones.split() + second
        for pre, pre_phones, block in _NEUTRAL_PREFIXES:
            if not word.startswith(pre) or len(word) - len(pre) < 3:
                continue
            b = word[len(pre):]
            if b in block or b in _NON_SECOND:
                continue
            pb = self._lexicon.get(b) or _COMPOUND_PARTS.get(b)
            pb_phones = (pb.split() if pb is not None
                         else self._strip_suffix(b, _COMPOUND_PARTS))
            if pb_phones is None:
                continue
            # the root keeps its own primary; the prefix is reduced
            return pre_phones.split() + list(pb_phones)
        return None

    _VOICELESS_FINAL = {"P", "T", "K", "F", "TH"}
    _SIBILANT_FINAL = {"S", "Z", "SH", "ZH", "CH", "JH"}

    def _strip_suffix(self, word: str,
                      extra: Optional[dict] = None) -> Optional[List[str]]:
        # compound second elements resolve their stems through the
        # curated parts table too (star+gazer works even when "gaze"
        # itself is absent from a trimmed lexicon — CV folds)
        def lookup(w: str) -> Optional[str]:
            hit = self._lexicon.get(w)
            if hit is None and extra is not None:
                hit = extra.get(w)
            if hit is None:
                # the curated parts table doubles as a mini-lexicon of
                # common stems (boxer = box+er works even when "box"
                # is absent from a trimmed lexicon)
                hit = _COMPOUND_PARTS.get(w)
            return hit

        def plural(stem_phones: List[str]) -> List[str]:
            last = stem_phones[-1].rstrip("012")
            if last in self._SIBILANT_FINAL:
                return stem_phones + ["IH0", "Z"]
            if last in self._VOICELESS_FINAL:
                return stem_phones + ["S"]
            return stem_phones + ["Z"]

        def past(stem_phones: List[str]) -> List[str]:
            last = stem_phones[-1].rstrip("012")
            if last in ("T", "D"):
                return stem_phones + ["IH0", "D"]
            if last in self._VOICELESS_FINAL or last in ("S", "SH", "CH"):
                return stem_phones + ["T"]
            return stem_phones + ["D"]

        def es_plural(stem_phones: List[str]) -> Optional[List[str]]:
            # -es only attaches after sibilants (boxes) or o (heroes);
            # elsewhere the e belongs to the stem (planes = plane+s,
            # ones = one+s), which the "s" candidate below handles
            last = stem_phones[-1].rstrip("012")
            if last in self._SIBILANT_FINAL or last == "OW":
                return plural(stem_phones)
            return None

        # -ancy/-ency nouns derive from their -ant/-ent adjectives
        # (vacancy <- vacant, agency <- agent) and -acy from -ate
        # (privacy <- private, accuracy <- accurate): CMUdict replaces
        # the base's final T with S IY0, keeping its stress pattern
        if word.endswith("cy") and len(word) > 5:
            if word[-4:-2] in ("an", "en"):
                base = word[:-2] + "t"
            elif word[-3] == "a":
                base = word[:-2] + "te"
            else:
                base = None
            if base is not None and base in self._lexicon:
                p = self._lexicon[base].split()
                if p[-1] == "T":
                    return p[:-1] + ["S", "IY0"]

        # adjectival/verbal -en attaches to l/d/k/p/w-final stems
        # (wooden, golden, woolen, weaken, sharpen, widen); other
        # finals are monomorphemic (haven, siren, soften)
        if word.endswith("en") and len(word) > 4 and word[-3] in "ldkpw":
            stem = word[:-2]
            for variant in (stem, stem + "e",
                            stem[:-1] if stem[-1:] == stem[-2:-1]
                            else stem):
                hit = lookup(variant)
                if hit is not None:
                    return hit.split() + ["AH0", "N"]

        # denominal -age (acreage, wreckage-style regulars: stem +
        # AH0 JH, the 2:1 majority convention in the gold lexicon)
        if word.endswith("age") and len(word) > 6:
            stem = word[:-3]
            for variant in (stem, stem + "e"):
                hit = lookup(variant)
                if hit is not None:
                    return hit.split() + ["AH0", "JH"]

        candidates = (
            ("'s", plural), ("s'", plural), ("es", es_plural),
            ("s", plural),
            ("ed", past),
            # syllabic-le stems elide the schwa before -ing (paddling
            # P AE1 D L IH0 NG, cycling — CMU convention)
            ("ing", lambda p: p[:-2] + ["L", "IH0", "NG"]
             if p[-2:] == ["AH0", "L"] else p + ["IH0", "NG"]),
            # a stem already ending in /l/ absorbs the suffix /l/
            # (general+ly = JH EH1 N ER0 AH0 L IY0, not ...L L IY0)
            ("ly", lambda p: p + ["IY0"]
             if p[-1].rstrip("012") == "L" else p + ["L", "IY0"]),
            ("ness", lambda p: p + ["N", "AH0", "S"]),
            ("ment", lambda p: p + ["M", "AH0", "N", "T"]),
            ("er", lambda p: p + ["ER0"]),
            ("est", lambda p: p + ["AH0", "S", "T"]),
        )
        for suffix, attach in candidates:
            if not word.endswith(suffix) or len(word) <= len(suffix):
                continue
            stem = word[: -len(suffix)]
            if len(stem) < 2 or not any(c in "aeiouy" for c in stem):
                # a 1-letter stem is never a real morphological base:
                # "west" is not we+est (W IY1 AH0 S T), "bed" not be+d;
                # nor is a vowel-less one ("shed" is not she+d)
                continue
            if suffix in ("er", "est") and word.endswith("eer"):
                # -eer words are monomorphemic (beer is not be+er;
                # steer, career): the eer -> IH1 R rule handles them
                continue
            if (
                suffix in ("er", "est")
                and stem in ("strong", "long", "young")
                and stem in self._lexicon
            ):
                # the -ng comparatives insert a hard G (stronger
                # S T R AO1 NG G ER0) unlike agentive -nger (singer);
                # lexicon membership is checked because CV folds drop
                # these stems
                base = self._lexicon[stem].split()
                return base + (
                    ["G", "ER0"] if suffix == "er"
                    else ["G", "AH0", "S", "T"]
                )
            variants = [stem, stem + "e"]
            if len(stem) >= 3 and stem[-1] == stem[-2]:
                # consonant doubling before a vowel-initial suffix
                # (logging -> log, batting -> bat, runner -> run)
                variants.append(stem[:-1])
            for variant in variants:
                hit = lookup(variant)
                if hit is not None:
                    attached = attach(hit.split())
                    if attached is not None:
                        # an attach that declines (es_plural on a
                        # non-sibilant stem) falls through to the next
                        # candidate instead of ending the search
                        return attached
            # consonant doubling: "stopped" -> stop + p + ed
            dedoubled = lookup(stem[:-1]) if (
                len(stem) >= 2 and stem[-1] == stem[-2]) else None
            if dedoubled is not None:
                attached = attach(dedoubled.split())
                if attached is not None:
                    return attached
        return None

    def _lts(self, word: str) -> List[str]:
        """Context-sensitive letter-to-sound (NRL-style ruleset in
        lts_rules.py), then heuristic stress assignment."""
        from .lts_rules import RULES

        text = f" {word} "
        phones: List[str] = []
        i = 1
        n = len(text) - 1
        while i < n:
            ch = text[i]
            bucket = RULES.get(ch)
            if bucket is None:
                i += 1
                continue
            advanced = False
            for left, grapheme, right, out in bucket:
                j = i + len(grapheme)
                if text[i:j] != grapheme:
                    continue
                if not _match_left(text, i - 1, left):
                    continue
                if not _match_right(text, j, right):
                    continue
                if out:
                    phones.extend(out.split())
                i = j
                advanced = True
                break
            if not advanced:
                i += 1
        return self._cmu_conventions(self._apply_stress(phones, word))

    # consonants after which American English drops the /Y/ glide of
    # long "u" (yod-dropping: juice, pseudo, rhubarb, tune, duty) —
    # measured in the gold lexicon: Y+UW after these never occurs,
    # while it is kept after labials/velars (music, cute, few) and,
    # inconsistently, after L and N (volume, menu vs avenue), which
    # are therefore left alone.
    _YOD_DROPPERS = frozenset("S Z R JH CH SH TH T D".split())

    @classmethod
    def _cmu_conventions(cls, phones: List[str]) -> List[str]:
        """Normalize rule output to CMUdict transcription conventions.

        - ``AH0 R`` -> ``ER0``: CMUdict never writes an unstressed
          schwa followed by R (around = ER0 AW1 N D, comfort =
          K AH1 M F ER0 T); the pair collapses whether the R is a coda
          or folded into a prevocalic ER (0 occurrences of AH0+R in
          the gold lexicon).
        - drop a ``Y`` glide before UW after yod-dropping consonants.
        - degeminate: adjacent identical consonant phones collapse
          (double letters straddling a rule boundary — offer, quarrel);
          CMUdict has no geminates (0 occurrences in the gold lexicon).
        - word-final regressive voicing assimilation: a voiced
          obstruent is never followed by a voiceless suffix consonant
          (surprised = ... Z D, countries = ... Z); final
          [B D G V Z ZH JH DH] + S/T voices to Z/D (0 counterexamples
          in the gold lexicon; sonorant+S/T like "else", "dreamt" are
          left alone).
        """
        out: List[str] = []
        i = 0
        n = len(phones)
        while i < n:
            p = phones[i]
            if p == "AH0" and i + 1 < n and phones[i + 1] == "R":
                out.append("ER0")
                i += 2
                continue
            if (
                p == "Y"
                and i + 1 < n
                and phones[i + 1].startswith("UW")
                and out
                and out[-1] in cls._YOD_DROPPERS
            ):
                i += 1
                continue
            if out and p == out[-1] and p[0] not in "AEIOU":
                i += 1  # consonant geminate
                continue
            out.append(p)
            i += 1
        if len(out) >= 2 and out[-2] in cls._VOICED_OBSTRUENTS:
            if out[-1] == "S":
                out[-1] = "Z"
            elif out[-1] == "T":
                out[-1] = "D"
        return out

    _VOICED_OBSTRUENTS = frozenset(
        ("B", "D", "G", "V", "Z", "ZH", "JH", "DH")
    )

    # suffixes that pull primary stress to the vowel immediately
    # before them (value = how many vowel phones the suffix itself
    # contributes) or to the final vowel (French-style endings)
    _PENULT_STRESS = {
        "tion": 1, "sion": 1, "cial": 1, "tial": 1, "cian": 1,
        "gion": 1, "ic": 1, "ics": 1, "ian": 1,
        "ity": 2, "ety": 2, "ical": 2, "ious": 2, "eous": 2,
        "uous": 2, "itive": 2, "graphy": 2, "logy": 2, "metry": 2,
        "pathy": 2, "ular": 2, "ularly": 3,
        # -ish verbs stress the penult (astonish, establish, demolish,
        # diminish; 2-syllable finish/punish/vanish are penult=first)
        "ish": 1, "ished": 1, "ishes": 1, "ishing": 1, "ishment": 2,
    }
    _FINAL_STRESS = ("ee", "eed", "teen", "oon", "esque", "ique", "ade",
                     "eer", "ette", "aire", "ere", "eres",
                     # French -et loans (lts_rules emits their EY);
                     # native -et words (banquet, wallet) never match
                     # these longer suffixes
                     "ouquet", "uffet", "ochet", "urmet")

    @classmethod
    def _final_stressed(cls, word: str) -> bool:
        # -stand carries final primary only in the under-/with- family
        # (understand, withstand); first-element compounds (grandstand,
        # handstand, kickstand) keep initial stress
        if word.endswith("stand") and word.startswith(("under", "with")):
            return True
        return any(word.endswith(sfx) for sfx in cls._FINAL_STRESS)

    # compounds/function words whose SECOND element carries the primary
    # (CMUdict: into IH0 N T UW1, without W IH0 TH AW1 T, sometimes
    # S AH0 M T AY1 M Z ...) — the first-vowel heuristic has no way to
    # see the morpheme boundary
    _SECOND_STRESS_WORDS = frozenset(
        """into without although throughout sometimes therein whereas
        whereby wherein herself himself itself myself yourself
        themselves ourselves idea ideas
        emerge emerged emerges emergency emergencies""".split()
    )

    # Consonant sequences that can open an English syllable.  A
    # word-initial "a" followed by a legal onset leaves the "a" as an
    # open unstressed syllable (about, across, asleep); an illegal
    # cluster closes the first syllable, which then carries stress
    # (after, answer, anger).  Measured on the gold lexicon: 69% of
    # a-initial polysyllables destress the first vowel.
    _LEGAL_ONSETS = frozenset(
        "bl br cl cr dr fl fr gl gr pl pr sl tr thr shr".split()
    )
    # Prefixes that reject stress (be-lieve, de-cide, re-turn); applied
    # only before a single non-doubled consonant.  Gold-lexicon rates:
    # be- 92%, de- 88%, re- 64% first-vowel-unstressed.
    _UNSTRESSED_PREFIXES = ("be", "de", "re", "in", "im", "con", "oc",
                            "per", "dis", "suc", "sug", "sup",
                            "sus", "ob", "pre")
    # a-initial words whose first syllable does carry stress despite a
    # legal onset shape, plus prefix-rule exceptions (nouns that keep
    # first-syllable stress: REcipe, REsearch...).
    _PREFIX_STRESS_EXCEPTIONS = frozenset(
        """any anybody anyone anything anywhere area areas able ably
        apron aprons acre acres agent agents alien aliens april
        adjective adjectives
        access accident accidents application applications average
        exercise exercises expert experts extra exit exits exile excellent
        influence influences income into instant instance industry
        recipe recipes research restaurant restaurants rendezvous
        record records region regions recent refuge rebel regular
        regularly depot depots decade decades demon demons
        exodus exorcist exorcists exoskeleton exoskeletons
        supper suppers
        allergy allergies appetite appetites appetizer appetizers
        injury injuries injure injured injures perjury perjuries
        distance distances alley alleys congress congresses
        consequence consequences consequently
        """.split()
    )

    @classmethod
    def _prefix_destresses(cls, word: str) -> bool:
        """True when the word's first syllable is an unstressed prefix
        and primary stress belongs on the second vowel."""
        if not word or word in cls._PREFIX_STRESS_EXCEPTIONS:
            return False
        vowels = "aeiouy"
        if word.startswith("ex") and len(word) >= 4:
            return True
        # e + single r + vowel: the e- is an unstressed prefix
        # syllable (erect, erode, erupt, erosion); err- (error,
        # errand) fails the vowel check and short era/Erie the length
        # check — twenty-sixth probe band
        if (word.startswith("er") and len(word) >= 5
                and word[2] in vowels):
            return True
        # with- prefixed verbs destress the prefix (withdraw,
        # withhold; 6-letter wither/within are too short to match) —
        # thirty-ninth probe band (band G)
        if word.startswith("with") and len(word) >= 8:
            return True
        # word-initial e + a legal 2-consonant onset leaves the e- as
        # an open unstressed syllable (eclipse IH0 K L IH1 P S);
        # single consonants stay ambiguous (elect vs elephant) and are
        # NOT destressed here — band-B analysis, round 5
        if (word[0] == "e" and len(word) >= 5
                and word[1:3] in cls._LEGAL_ONSETS):
            return True
        # to- destresses only before the d/g/m/n stems (today, together,
        # tomorrow, tonight) — a bare "to" + w/t (tower, total) keeps
        # first-syllable stress
        if word.startswith("to") and len(word) >= 5 and word[2] in "dgmn":
            return True
        if word[0] == "a" and len(word) >= 3:
            run = ""
            for ch in word[1:]:
                if ch in vowels:
                    break
                run += ch
            if not run or len(run) > 3:
                return False
            if len(word) <= 1 + len(run):  # no second syllable
                return False
            if len(run) == 1:
                return True
            if run[0] == run[1] and (
                len(run) == 2 or run[1:] in cls._LEGAL_ONSETS
            ):
                # geminate spelling = single onset (attack, appear),
                # incl. geminate+liquid clusters (apprentice, attract,
                # approve, aggressive, address)
                return True
            if run in ("cq", "dj"):
                # spelling geminates of a single sound (acquire,
                # acquaint, adjust, adjourn; "adjective" is in the
                # exceptions list) — round-5 CV sweep
                return True
            return run in cls._LEGAL_ONSETS
        for pfx in cls._UNSTRESSED_PREFIXES:
            if (
                word.startswith(pfx)
                and len(word) >= len(pfx) + 3
                and word[len(pfx)] not in vowels
                and word[len(pfx)] != word[len(pfx) + 1]  # beTTer
                # single C, a Cl/Cr/Cw onset (beTWeen), or an s+C
                # cluster (reSTore, deSPair, deSTroy)
                and (word[len(pfx) + 1] in vowels + "lrw"
                     or (word[len(pfx)] == "s"
                         and word[len(pfx) + 1] not in vowels))
            ):
                return True
        return False

    @classmethod
    def _apply_stress(cls, phones: List[str], word: str = "") -> List[str]:
        """Heuristic stress: primary on the first full vowel, except
        that penult-stressing suffixes (-tion, -ity, ...) move it to
        the second-to-last vowel and French-style endings (-ee, -ique,
        ...) to the last. ``AX`` (rule-engine schwa) is never stressed
        and becomes AH0. A rule output that already carries an explicit
        ``*1`` digit pins the whole word: every heuristic (including
        vowel reduction and secondary promotion on pinned indices) is
        suppressed."""
        idxs = [i for i, p in enumerate(phones) if p in _STRESSABLE]
        target = idxs[0] if idxs else -1
        pinned = any(p.endswith("1") for p in phones)
        if pinned:
            # a rule already pinned the primary (irregular-word rules
            # emit explicit digits); bare vowels are all unstressed
            target = -1
        # plurals/3rd-person forms stress like their stem
        # (applications stresses like application; activities like
        # activity)
        stem = word[:-1] if word.endswith("s") else word
        if word.endswith("ies"):
            stem = word[:-3] + "y"
        suffix_vowels = max(
            (k for sfx, k in cls._PENULT_STRESS.items()
             if word.endswith(sfx) or stem.endswith(sfx)),
            default=0,
        )
        if pinned:
            pass  # rule-pinned digits win over every heuristic
        elif idxs and suffix_vowels:
            vowels = [i for i, p in enumerate(phones)
                      if p in _STRESSABLE or p == "AX"]
            # the vowel right before the suffix, skipping schwas leftward
            pos = len(vowels) - 1 - suffix_vowels
            while pos >= 0:
                if phones[vowels[pos]] in _STRESSABLE:
                    target = vowels[pos]
                    break
                pos -= 1
        elif idxs and cls._final_stressed(word):
            target = idxs[-1]
        elif len(idxs) >= 2 and (word in cls._SECOND_STRESS_WORDS
                                 or cls._prefix_destresses(word)):
            target = idxs[1]
            # the destressed prefix "a" is always schwa (about, ago);
            # destressed e-prefixes raise to IH (bIHlieve, rIHturn,
            # dIHspair - CMU writes the reduced e-prefix vowel as IH0)
            if word[0] == "a":
                phones = list(phones)
                phones[idxs[0]] = "AX"
            elif ((word[1] == "e" or word[0] == "e")
                  and phones[idxs[0]] == "EH"):
                # destressed e-prefixes raise to IH whether the e is
                # the prefix vowel itself (emergency) or follows an
                # onset consonant (believe, return)
                phones = list(phones)
                phones[idxs[0]] = "IH"
        out: List[str] = []
        for i, p in enumerate(phones):
            if p == "AX":
                out.append("AH0")
            elif p in _STRESSABLE:
                out.append(p + ("1" if i == target else "0"))
            elif p and p[-1] in "012":
                out.append(p)
            else:
                out.append(p)
        if word in cls._FUNCTION_WORD_STRESS:
            tag = cls._FUNCTION_WORD_STRESS[word]
            out = [
                p[:-1] + tag if p[-1] in "012" else p for p in out
            ]
        # vowel reduction runs for BOTH heuristic and rule-pinned
        # words: vowels a rule emitted WITH a digit (subject's
        # JH EH0 K T, a suffix rule's OW1) are exact CMUdict forms and
        # never reduce, but the rest of a pinned word's vowels came
        # from ordinary digitless rules and reduce around the pinned
        # primary exactly as they would around a heuristic one
        # (procedure's pro-, exposure's ex-). Before round 5 pinning
        # froze the whole word, which blocked suffix rules from
        # pinning a non-initial primary (-osure, -osity, ...).
        keep = frozenset(
            i for i, p in enumerate(phones)
            if p and p[-1] in "012"
        )
        # pinned words reduce only OPEN adjacent syllables: suffix
        # rules pin mid-word primaries whose open pretonics reduce
        # (procedure's pro-, velocity's ve-), while closed pretonics
        # next to a pinned suffix keep quality (antenna AE0 N T EH1,
        # campaign K AE0 M P EY1 N) — heuristic words keep the
        # original unconditional adjacency rule the gold floor was
        # measured on
        out = cls._reduce_unstressed(out, word, keep=keep,
                                     open_only=pinned)
        # indices the secondary pass must not promote: vowels whose
        # digit a rule pinned explicitly, and schwas that came from AX
        # (a schwa never takes secondary stress: communication's first
        # AH0, unlike understand's full AH0)
        no_promote = frozenset(
            i for i, p in enumerate(phones)
            if p == "AX" or (p and p[-1] in "012")
        )
        return cls._apply_secondary(out, word, no_promote=no_promote)

    # CMUdict's stress on monosyllabic function words is lexical (of
    # AH1 V but in IH0 N, her HH ER0); the heuristic defaults to 1,
    # which is wrong for exactly these
    _FUNCTION_WORD_STRESS = {"of": "1", "in": "0", "her": "0",
                             "the": "0", "a": "0"}

    # full vowels that keep secondary stress in an unstressed CLOSED
    # final syllable (catalogue AO2 G, diaphragm AE2 M, almost OW2 S T,
    # demonstrate EY2 T); EH/IH/AH instead reduce or stay 0 there
    # (comment K AA1 M EH0 N T)
    _FINAL_FULL = frozenset(["AE", "AA", "AO", "OW", "AY", "AW", "OY",
                             "UW", "EY"])

    @classmethod
    def _apply_secondary(cls, phones: List[str], word: str,
                         no_promote: frozenset = frozenset()) -> List[str]:
        """Secondary-stress placement after primary assignment and
        vowel reduction (CMUdict conventions; the `*2` tokens are
        first-class model vocabulary, reference voice100/text.py:19-31).

        Rules, each measured on the gold lexicon:
        * dual primary on -teen numerals (thirteen TH ER1 T IY1 N);
        * a full first vowel >= 2 syllables before the primary takes 2
          (information IH2 ... EY1, guarantee G EH2 ... IY1);
        * the -ary/-ery/-ory suffix vowel >= 2 syllables after the
          primary takes 2 (secretary ... T EH2 R IY0);
        * a retained full vowel in a closed final syllable after the
          primary takes 2 (dialogue D AY1 AH0 L AO2 G), as does a
          word-final spelled -ay (monday M AH1 N D EY2) — but spelled
          -ow stays reduced (window W IH1 N D OW0).
        """
        vowel_idx = [i for i, p in enumerate(phones) if p[-1:] in "012"]
        prim = [k for k, i in enumerate(vowel_idx)
                if phones[i].endswith("1")]
        if not prim or len(vowel_idx) < 2:
            return phones
        out = list(phones)
        first_k, last_k = 0, len(vowel_idx) - 1
        first_i, last_i = vowel_idx[0], vowel_idx[-1]

        # CMUdict gives the -teen numerals dual primaries (thirteen
        # TH ER1 T IY1 N) — except sixteen/eighteen (S IH0, EY0)
        if (
            word.endswith("teen") and first_k < prim[0]
            and word not in ("sixteen", "eighteen")
        ):
            if phones[first_i][:-1] in _STRESSABLE:
                out[first_i] = phones[first_i][:-1] + "1"
                return out

        if (
            prim[0] - first_k >= 2
            and first_i not in no_promote
            and phones[first_i].endswith("0")
            and phones[first_i][:-1] in _STRESSABLE
        ):
            out[first_i] = phones[first_i][:-1] + "2"

        if (
            word.endswith(("ary", "ery", "ory", "aries", "eries",
                           "ories"))
            and len(vowel_idx) >= 4
            and last_k - 1 > prim[-1] + 1
        ):
            sfx_i = vowel_idx[last_k - 1]
            if phones[sfx_i][:-1] in ("EH", "AO") and (
                phones[sfx_i].endswith("0")
            ):
                out[sfx_i] = phones[sfx_i][:-1] + "2"
                return out

        if last_k > prim[-1] and last_i not in no_promote:
            # (pinned rule outputs already carry their exact final
            # digit: monarch M AA1 N AA0 R K, chaos K EY1 AA0 S)
            p_last = phones[last_i]
            closed = last_i < len(phones) - 1
            if p_last.endswith("0") and p_last[:-1] in cls._FINAL_FULL:
                if closed and not word.endswith(("ow", "ows")):
                    out[last_i] = p_last[:-1] + "2"
                elif (not closed and p_last[:-1] == "OW"
                        and word.endswith(("rrow", "rrows"))):
                    # CMU gives the -rrow family a secondary (borrow
                    # B AA1 R OW2, tomorrow, sorrow) though -llow/-dow
                    # stay reduced (follow, window)
                    out[last_i] = "OW2"
                elif (not closed and p_last[:-1] == "EY"
                        and word.endswith(("ay", "ays"))):
                    out[last_i] = p_last[:-1] + "2"
            elif p_last.endswith("0") and word in cls._SECONDARY_FINAL:
                # compounds whose reduced-looking final vowel is a full
                # morpheme (in+come IH1 N K AH2 M, ac+cess AE1 K S EH2 S)
                out[last_i] = p_last[:-1] + "2"
        return out

    _SECONDARY_FINAL = frozenset(
        """income incomes somewhat somewhere anywhere everywhere
        access accesses process processes""".split()
    )

    # vowels whose spelling pronunciation most often reduces to schwa
    # when unstressed (the dominant LTS error class measured against
    # the gold lexicon)
    _REDUCIBLE = {"AE", "AA", "EH", "AO", "EY"}

    # phone-level onset clusters English allows syllable-initially
    # (stop/fricative + liquid/glide, s + stop/sonorant); used by the
    # pinned-word open-syllable test under onset maximization
    _ONSETS_2 = frozenset(
        "P R,P L,B R,B L,T R,D R,K R,K L,G R,G L,F R,F L,TH R,"
        "SH R,S T,S P,S K,S L,S M,S N,S W,S F,K W,T W,D W,G W"
        .split(",")
    )
    _ONSETS_3 = frozenset(
        "S T R,S P R,S P L,S K R,S K W".split(",")
    )

    @classmethod
    def _open_syllable(cls, phones, vowel_idx, k, i) -> bool:
        """True when vowel ``k`` (phone index ``i``) ends an open
        syllable: every consonant phone before the next vowel forms a
        legal onset of that next syllable."""
        if k + 1 >= len(vowel_idx):
            return False
        cluster = [p for p in phones[i + 1:vowel_idx[k + 1]]]
        if len(cluster) <= 1:
            return True
        joined = " ".join(cluster)
        if len(cluster) == 2:
            return joined in cls._ONSETS_2
        if len(cluster) == 3:
            return joined in cls._ONSETS_3
        return False

    @classmethod
    def _reduce_unstressed(cls, phones: List[str], word: str = "",
                           keep: frozenset = frozenset(),
                           open_only: bool = False) -> List[str]:
        """Unstressed-vowel reduction: a reducible vowel in the syllable
        adjacent to the primary stress reduces to schwa (English stress
        alternation puts secondary stress two syllables away, so the
        adjacent syllable is the reliably reduced one). Word-final
        vowels keep their quality ("window", "monday") — except a
        final spelled 'a', which is essentially always schwa ("sofa",
        "banana"). -teen numerals keep their FIRST vowel full (CMUdict
        gives it a primary: fourteen F AO1 R T IY1 N) while medial ones
        still reduce (seventeen S EH1 V AH0 N T IY1 N)."""
        protect_first = word.endswith("teen")
        if (
            word.endswith("a")
            and phones
            and phones[-1].endswith("0")
            and phones[-1][:-1] in ("AE", "AA", "EY")
            and (len(phones) - 1) not in keep
        ):
            phones = phones[:-1] + ["AH0"]
        vowel_idx = [
            i for i, p in enumerate(phones)
            if p[:-1] in _STRESSABLE or p[:-1] == "AH"
        ]
        prim = [k for k, i in enumerate(vowel_idx)
                if phones[i].endswith("1")]
        if not prim:
            return phones
        prim_syl = prim[0]
        out = list(phones)
        # final "-cess" keeps its full vowel (CMU gives it secondary
        # stress: access AE1 K S EH2 S, princess, process)
        last_keep = vowel_idx[-1] if word.endswith("cess") else None
        for k, i in enumerate(vowel_idx):
            p = phones[i]
            if (
                p.endswith("0")
                and p[:-1] in cls._REDUCIBLE
                and i not in keep
                and i != len(phones) - 1
                and i != last_keep
                and abs(k - prim_syl) == 1
                and not (protect_first and k == 0)
                # word-initial spelled "au" keeps its AO quality when
                # pretonic (audacity AO0 D AE1 S..., austere, audition)
                # — band-N analysis, round 5
                and not (k == 0 and word.startswith("au"))
                # final -aught keeps its AO too (onslaught
                # AA1 N S L AO2 T carries a CMU secondary) — band U
                and not (p[:-1] == "AO"
                         and word.endswith(("aught", "aughts")))
                # pretonic spelled-"ar" in a closed syllable keeps
                # AA0 R (harpoon, sardine, cartoon, carnation,
                # marquee); CMU reduces only the open-syllable cases
                # (parade P ER0 EY1 D) — round-5 final CV sweep
                and not (
                    p[:-1] == "AA" and k < prim_syl
                    and i + 1 < len(phones) and phones[i + 1] == "R"
                    and i + 2 < len(phones)
                    and not phones[i + 2][-1].isdigit()
                )
                # open_only (rule-pinned words): the vowel's syllable
                # must be open under onset maximization — the whole
                # consonant cluster before the next vowel syllabifies
                # as that syllable's onset (approval a.PRO, procedure
                # pro.CE), else the syllable is closed and keeps its
                # quality (antenna an.TEN, campaign cam.PAIGN)
                and (
                    not open_only
                    or cls._open_syllable(phones, vowel_idx, k, i)
                )
                # NOTE: final full-vowel+R syllables are deliberately
                # still reduced (comfort/orchard/dollar -> ER0) even
                # though compound-ish second elements lexically keep
                # quality (airport AO2 R T) — that split is lexical,
                # and the reducing class is the bigger one; the
                # compound exceptions live in the lexicon
            ):
                # a word-initial unstressed vowel spelled bare "e"
                # reduces to IH0 in CMU, not schwa (elect, event,
                # effect, eleven, especially) — round-5 CV sweep
                if i == 0 and word.startswith("e"):
                    out[i] = "IH0"
                # the re-/de-/pre- prefix vowel likewise reduces to
                # IH0 (refraction R IH0 F R AE1 K SH AH0 N, demand,
                # prediction) — band-O analysis, round 5
                elif k == 0 and word.startswith(("re", "de", "pre")):
                    out[i] = "IH0"
                else:
                    out[i] = "AH0"
            # NOTE (round-5, band A analysis): a post-tonic
            # open-syllable IH0 -> AH0 rule was tried and REVERTED —
            # CMUdict's spelled-i reduction is lexical, near 50/50
            # (festival/president/editor reduce; hospital/bicycle/
            # technical/criticize keep IH0). Words on the reducing
            # side are lexicon entries, not a rule.
        # medial spelled-i IH0 reduces to schwa before n/l/m/b/d/v/p/f
        # (CMU convention: festival, stamina, polymer, attribute,
        # centipede, subsidy, nautilus, centrifuge); before k/t/g it
        # is lexical (technical, hospital, resignation keep IH0) and
        # the word-initial vowel is prefix territory (re-/de-/pre-
        # and bare e- reduce to IH0, not past it) — round-5 CV sweep
        for k, i in enumerate(vowel_idx):
            if (
                k == 0 or k == len(vowel_idx) - 1 or i in keep
                or out[i] != "IH0"
            ):
                continue
            nxt = out[i + 1].rstrip("012")
            if (
                nxt in ("N", "L", "M", "B", "D", "V", "P", "F")
                # ... but not before n+glide (-inion/-inia words keep
                # IH0: dominion, opinion); b+glide still reduces
                # (attribute AE1 T R AH0 B Y UW2 T, contribution)
                and not (nxt == "N"
                         and i + 2 < len(out) and out[i + 2] == "Y")
            ):
                out[i] = "AH0"
            elif (
                nxt == "T"
                and i + 2 < len(out)
                and out[i + 2][-1] in "12"
            ):
                # i before t reduces when the t's syllable is stressed
                # (-itate/-itude/-itime: maritime M EH1 R AH0 T AY2 M,
                # gravitational, hesitate) but keeps IH0 before a weak
                # syllable (hospital, creditor, hesitant)
                out[i] = "AH0"
            elif nxt in ("S", "Z") and k < prim_syl:
                # pretonic i before a sibilant reduces (antiseptic
                # AE2 N T AH0 S EH1 P..., aristocracy, calisthenics);
                # post-tonic keeps IH0 (criticize)
                out[i] = "AH0"
        # FINAL-syllable IH0 with a plain {T,D,N} coda reduces (the
        # gold convention: visit V IH1 Z AH0 T, audit, dolphin,
        # cousin, margin); epenthetic past -ted/-ded and the -men
        # plural keep IH0, as do sibilant codas (-ist, -es plurals)
        # and non-coronal codas (-ing/-ish/-ic/-ive) — band-B
        # analysis, round 5
        last_i = vowel_idx[-1]
        coda = out[last_i + 1:]
        if (
            out[last_i] == "IH0"
            and last_i not in keep
            and coda
            and all(c in ("T", "D", "N") for c in coda)
            # epenthetic past -ted/-ded, the -men plural, and the -kin
            # morpheme (napkin, pumpkin) keep IH0
            and not word.endswith(("ted", "ded", "men", "kin"))
        ):
            out[last_i] = "AH0"
        return out


def _match_left(text: str, pos: int, pattern: str) -> bool:
    """Match a rule's left context right-to-left ending at ``pos``.

    ``:`` (zero or more consonants) backtracks: all consumption counts
    are tried so patterns like ``#^:e`` match both "baked" and
    "worked" — an improvement over the classic greedy matcher.
    """
    i = len(pattern) - 1
    p = pos
    while i >= 0:
        c = pattern[i]
        if c.isalpha() or c == "'":
            if p < 0 or text[p] != c:
                return False
            p -= 1
        elif c == " ":
            if p >= 0 and (text[p].isalpha() or text[p] == "'"):
                return False
            p -= 1
        elif c == "#":  # one or more vowels
            if p < 0 or text[p] not in _VOWELS:
                return False
            while p >= 0 and text[p] in _VOWELS:
                p -= 1
        elif c == ":":  # zero or more consonants, with backtracking
            rest = pattern[:i]
            q = p
            while True:
                if _match_left(text, q, rest):
                    return True
                if q < 0 or text[q] not in _CONSONANTS:
                    return False
                q -= 1
        elif c == "^":  # one consonant
            if p < 0 or text[p] not in _CONSONANTS:
                return False
            p -= 1
        elif c == ".":  # one voiced consonant
            if p < 0 or text[p] not in _VOICED:
                return False
            p -= 1
        elif c == "+":  # one front vowel
            if p < 0 or text[p] not in _FRONT:
                return False
            p -= 1
        elif c == "&":  # sibilant (incl. ch/sh digraphs)
            if p >= 1 and text[p] == "h" and text[p - 1] in ("c", "s"):
                p -= 2
            elif p >= 0 and text[p] in _SIBILANT:
                p -= 1
            else:
                return False
        elif c == "@":  # consonant after which long u loses its glide
            if p >= 1 and text[p] == "h" and text[p - 1] in ("t", "c", "s"):
                p -= 2
            elif p >= 0 and text[p] in _LONG_U:
                p -= 1
            else:
                return False
        else:
            return False
        i -= 1
    return True


def _match_right(text: str, pos: int, pattern: str) -> bool:
    """Match a rule's right context left-to-right starting at ``pos``."""
    i = 0
    p = pos
    n = len(text)
    while i < len(pattern):
        c = pattern[i]
        if c.isalpha() or c == "'":
            if p >= n or text[p] != c:
                return False
            p += 1
        elif c == " ":
            if p < n and (text[p].isalpha() or text[p] == "'"):
                return False
            p += 1
        elif c == "#":
            if p >= n or text[p] not in _VOWELS:
                return False
            while p < n and text[p] in _VOWELS:
                p += 1
        elif c == ":":  # zero or more consonants, with backtracking
            rest = pattern[i + 1:]
            q = p
            while True:
                if _match_right(text, q, rest):
                    return True
                if q >= n or text[q] not in _CONSONANTS:
                    return False
                q += 1
        elif c == "^":
            if p >= n or text[p] not in _CONSONANTS:
                return False
            p += 1
        elif c == ".":
            if p >= n or text[p] not in _VOICED:
                return False
            p += 1
        elif c == "+":
            if p >= n or text[p] not in _FRONT:
                return False
            p += 1
        elif c == "&":
            if p + 1 < n and text[p] in ("c", "s") and text[p + 1] == "h":
                p += 2
            elif p < n and text[p] in _SIBILANT:
                p += 1
            else:
                return False
        elif c == "@":
            if p + 1 < n and text[p] in ("t", "c", "s") and text[p + 1] == "h":
                p += 2
            elif p < n and text[p] in _LONG_U:
                p += 1
            else:
                return False
        elif c == "%":  # word-final suffix: e / er / es / ed / ely / ing
            if text.startswith("ing", p):
                p += 3
            elif text[p:p + 1] == "e":
                if text.startswith("ely", p):
                    p += 3
                elif text[p + 1:p + 2] in ("r", "s", "d"):
                    p += 2
                else:
                    p += 1
            else:
                return False
            # NRL suffixes end the word (possibly via a further suffix:
            # -edly, -ers, -ingly...); a following stem letter means
            # this was not a suffix at all ("gen-er-al")
            if p < n and text[p] not in " sdlyr":
                return False
        else:
            return False
        i += 1
    return True
