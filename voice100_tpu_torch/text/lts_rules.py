"""Context-sensitive English letter-to-sound rules.

A reconstruction of the classic public-domain NRL text-to-phoneme
ruleset (Elovitz, Johnson, McHugh & Shore, *Automatic Translation of
English Text to Phonetics by Means of Letter-to-Sound Rules*, NRL
Report 7948, 1976 — a U.S. government work), adapted to the CMU/ARPAbet
phone inventory used by this framework's tokenizers
(reference voice100/text.py:19-31).

Rule format: ``(left, grapheme, right, phones)``. At each position the
first rule whose ``grapheme`` matches the text and whose left/right
context patterns match wins; the cursor advances past ``grapheme``.

Context pattern symbols (from the NRL notation):

- ``#``  one or more vowel letters (a e i o u y)
- ``:``  zero or more consonant letters
- ``^``  exactly one consonant letter
- ``.``  one voiced consonant (b d v g j l m n r w z)
- ``+``  one front vowel (e i y)
- ``&``  a sibilant: s, c, g, z, x, j or the digraphs ch/sh
- ``@``  a consonant after which long "u" drops its y-glide:
         t, s, r, d, l, z, n, j or th/ch/sh
- ``%``  one of the suffixes e, er, es, ed, ing, ely
- `` ``  (space) a word boundary
- letters match themselves

Phones are CMU symbols without stress digits; ``AX`` denotes an
unstressable schwa that maps to ``AH0`` (stress is assigned
afterwards by the G2P driver). ``WH`` from the original table is
folded to ``W`` (CMU has no WH).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["RULES"]

Rule = Tuple[str, str, str, str]

# Rules bucketed by the first letter of the grapheme; "'" bucket holds
# apostrophe rules. Order within a bucket is significant.
RULES: Dict[str, List[Rule]] = {
    "a": [
        # Latin plural -ae reads IY0 (larvae, antennae, algae,
        # vertebrae) — round-5 final CV sweep
        ("^", "ae", " ", "IY0"),
        # amortize family stresses the initial A (AE1 M ER0 T AY2 Z)
        # against the about-style schwa prefix — band M
        (" ", "amortiz", "", "AE1 M ER0 T AY2 Z"),
        # capacitor/capacitance stress the second syllable
        # (K AH0 P AE1 S AH0 T ER0) — band O
        ("p", "acit", "", "AE1 S AX T"),
        # -acious Latinate adjectives stress the long A (gracious,
        # audacious, tenacious ... EY1 SH AH0 S); right context open
        # so -aciously/-aciousness ride along — band S
        ("", "acious", "", "EY1 SH AX S"),
        # -acy abstract nouns reduce the suffix a (advocacy, literacy,
        # candidacy ... AH0 S IY0) — band P
        ("", "acies", " ", "AX S IY0 Z"),
        ("", "acy", " ", "AX S IY0"),
        # Italian -atta loans read the broad A (regatta
        # R AH0 G AA1 T AH0) like the -ava family below — band M
        ("", "atta", " ", "AA1 T AH0"),
        ("", "attas", " ", "AA1 T AH0 Z"),
        # final -ava loans read the broad A (lava L AA1 V AH0, java,
        # guava, cassava) — forty-fourth probe band (band L)
        ("", "ava", " ", "AA1 V AH0"),
        ("", "avas", " ", "AA1 V AH0 Z"),
        # dr + ama keeps the broad A too (drama D R AA1 M AH0,
        # melodrama) — band L
        ("dr", "ama", " ", "AA1 M AH0"),
        ("dr", "amas", " ", "AA1 M AH0 Z"),
        # Greek -asm nominals carry a secondary on the suffix and an
        # epenthetic schwa before the M (sarcasm S AA1 R K AE2 Z AH0 M,
        # enthusiasm, spasm) — thirty-fifth probe band (band A)
        ("", "asm", " ", "AE2 Z AX M"),
        ("", "asms", " ", "AE2 Z AX M Z"),
        # word-initial asc- Latinate verbs reduce the prefix vowel
        # (ascend AH0 S EH1 N D, ascent) — round-5 CV sweep
        (" ", "ascen", "", "AX S EH1 N"),
        (" ", "absorb", "", "AH0 B Z AO1 R B"),
        (" ", "adjourn", "", "AH0 JH ER1 N"),
        # voiceless medial s in -asin (moccasin M AA1 K AH0 S AH0 N)
        ("c", "asin", " ", "AX S AX N"),
        ("", "aprika", "", "AE0 P R IY1 K AH0"),
        # reduced -ately adverbs (deliberately, fortunately,
        # immediately); lately/stately keep EY via the left-vowel
        # requirement
        ("#:^", "ately", " ", "AX T L IY0"),
        # acoustic family stresses the long U (AH0 K UW1 S T IH0 K)
        (" ", "acoust", "", "AX K UW1 S T"),
        # activity keeps the full front A (AE0 K T IH1 V AH0 T IY0);
        # activate's different stress keeps its own path
        (" ", "activit", "", "AE0 K T IH1 V AH0 T"),
        # -alla-/-alle- nominals keep the front AE against the AO of
        # "(b)all" (ballad B AE1 L AH0 D, gallant, mallet, pallet);
        # w-onsets (wallet, wallaby) keep their own wa- rules
        ("b", "alla", "^", "AE L AX"),
        ("g", "alla", "^", "AE L AX"),
        ("m", "allet", " ", "AE L AX T"),
        ("p", "allet", " ", "AE L AX T"),
        # w colors a following a before nasal clusters (swamp
        # S W AA1 M P)
        ("w", "a", "mp", "AA"),
        # wharf keeps the AO of "war" (W AO1 R F)
        ("wh", "ar", "", "AO R"),
        # Latin -aurus keeps the AO diphthong value (thesaurus
        # TH AH0 S AO1 R AH0 S, tyrannosaurus)
        ("", "aurus", " ", "AO1 R AX S"),
        # Latin -andum nominals stress the suffix (memorandum)
        ("", "andum", " ", "AE1 N D AX M"),
        ("n", "asium", " ", "EY1 Z IY0 AX M"),
        ("t", "aphor", "", "AX F AO2 R"),
        ("", "athedral", "", "AX TH IY1 D R AX L"),
        (" ", "apparat", "", "AE2 P ER0 AE1 T"),
        (" ", "asparag", "", "AX S P EH1 R AX G"),
        # agentive/instrument -ator keeps a secondary long A when the
        # stem is two or more syllables (elevator EH1 L AH0 V EY2 T ER0,
        # calculator, educator) or ends in a hiatus i (radiator,
        # aviator, gladiator) or the clusters of dictator/spectator,
        # narrator, translator; short stems reduce (senator, orator)
        # and a vowel immediately before keeps its own primary
        # (creator, equator) — round-5 CV sweep
        ("#:^#:^", "ator", " ", "EY2 T ER0"),
        ("#:^#:^", "ators", " ", "EY2 T ER0 Z"),
        ("i", "ator", " ", "EY2 T ER0"),
        ("i", "ators", " ", "EY2 T ER0 Z"),
        ("ct", "ator", " ", "EY2 T ER0"),
        ("ct", "ators", " ", "EY2 T ER0 Z"),
        ("rr", "ator", " ", "EY2 T ER0"),
        ("rr", "ators", " ", "EY2 T ER0 Z"),
        ("sl", "ator", " ", "EY2 T ER0"),
        ("sl", "ators", " ", "EY2 T ER0 Z"),
        # alcove pre-empts the alc- hard-K family's vowel
        ("", "alcove", "", "AE1 L K OW2 V"),
        # -adle keeps the long A (ladle, cradle); doubled saddle is
        # untouched — forty-first probe band (band I)
        ("", "adle", "", "EY D AX L"),
        # consonant + aper is the long-A open syllable (taper, paper,
        # caper, draper); word-initial aperture keeps AE via the
        # required left consonant — forty-first probe band
        ("^", "aper", "", "EY P ER"),
        # word-final -alm family: silent l, dark AA (palm, calm, balm,
        # balmy) — almost/already keep their AO L via narrower scope —
        # fortieth probe band (band H)
        ("", "alm", " ", "AA M"),
        ("", "alms", " ", "AA M Z"),
        ("", "almy", " ", "AA M IY0"),
        # "alv" keeps the full AE L V (salvage, valve, galvanize) —
        # fortieth probe band
        ("", "alv", "", "AE L V"),
        # "alc" keeps the full AE L + hard/soft c (calcium's c softens
        # before i; falcon, balcony, alcohol keep K); walk/chalk spell
        # "alk" and keep their silent-l rules — thirty-ninth probe
        # band (band G)
        ("", "alcium", " ", "AE L S IY0 AX M"),
        ("", "alci", "", "AE L S IH"),
        ("", "alc", "", "AE L K"),
        # chemical/loan -ane keeps the long A with a secondary when a
        # syllable precedes (methane, propane, membrane, airplane);
        # monosyllabic crane/plane keep the plain magic-e via the
        # vowel-requiring left context — thirty-seventh probe band
        # (band C)
        ("#:^", "ane", " ", "EY2 N"),
        ("#:^", "anes", " ", "EY2 N Z"),
        # Greek -archy/-arch compounds keep the velar (monarchy,
        # hierarchy, oligarchy, monarch) against ch->CH; word-initial
        # arch- (archway, archbishop) keeps CH via the left context —
        # thirty-fifth probe band
        ("", "archy", " ", "AA2 R K IY0"),
        ("", "archies", " ", "AA2 R K IY0 Z"),
        ("#:", "arch", " ", "AA0 R K"),
        ("#:", "archs", " ", "AA0 R K S"),
        # -asis before the "as" digraph rule (basis, oasis) —
        # twenty-sixth probe band
        ("", "asis", " ", "EY1 S AH0 S"),
        # -ageous keeps the suffix-stressed long A (courageous,
        # outrageous, advantageous) — twenty-eighth probe band
        ("", "ageous", " ", "EY1 JH AH0 S"),
        # -ache compound second element (headache, toothache,
        # backache); mustache is pinned in the m-bucket —
        # twenty-seventh probe band (medicine/health)
        ("#:", "ache", " ", "EY2 K"),
        ("#:", "aches", " ", "EY2 K S"),
        ("g", "allery", "", "AE L ER IY"),
        (" ", "annual", " ", "AE1 N Y UW0 AH0 L"),
        (" ", "asia", "", "EY1 ZH AH0"),
        (" ", "antarctica", "", "AE0 N T AA1 R K T IH0 K AH0"),
        (" ", "antarctic", "", "AE0 N T AA1 R K T IH0 K"),
        (" ", "asham", "", "AH0 SH EY1 M"),
        # advice/advise keep the stressed AY against the reduced
        # final-ice rule — twenty-fourth probe band
        (" ", "advice", " ", "AH0 D V AY1 S"),
        (" ", "arrogan", "", "EH1 R AH0 G AH0 N"),
        (" ", "avenue", "", "AE1 V AH0 N UW2"),
        (" ", "airport", "", "EH1 R P AO2 R T"),
        (" ", "adobe", "", "AH0 D OW1 B IY0"),
        ("r", "azor", "", "EY Z ER"),
        # high-precision irregular classes (round-3 gold-set error
        # analysis): common-word spellings the general rules get wrong
        (" ", "algorithm", "", "AE1 L G ER0 IH2 DH AH0 M"),
        # strong-verb participle -aken (taken, shaken, mistaken)
        ("", "aken", " ", "EY K AX N"),
        (" ", "architecture", "", "AA1 R K AH0 T EH2 K CH ER0"),
        (" ", "adventur", "", "AE0 D V EH1 N CH ER0"),
        (" ", "agriculture", "", "AE1 G R IH0 K AH2 L CH ER0"),
        (" ", "automobile", "", "AO1 T AH0 M OW0 B IY2 L"),
        (" ", "acknowledg", "", "AE0 K N AA1 L IH0 JH"),
        (" ", "accept", "", "AE0 K S EH1 P T"),
        (" ", "accident", "", "AE1 K S AX D AX N T"),
        (" ", "acc", "+", "AE K S"),
        (" n", "ature", " ", "EY CH ER"),
        ("#:^", "ature", " ", "AH0 CH ER0"),
        (" ", "ancient", "", "EY1 N CH AX N T"),
        (" ", "anxious", "", "AE1 NG K SH AX S"),
        (" ", "anxiet", "", "AE0 NG Z AY1 AX T"),
        (" ", "anger", "", "AE NG G ER"),
        ("h", "a", "sten", "EY"),
        ("m", "arriage", "", "EH1 R IH0 JH"),
        ("", "avorite", "", "EY1 V ER0 IH0 T"),
        ("", "avourite", "", "EY1 V ER0 IH0 T"),
        ("", "avor", "", "EY V ER"),
        ("dr", "aught", "", "AE F T"),
        (" ", "asthma", "", "AE1 Z M AH0"),
        (" ", "architect", "", "AA1 R K AX T EH2 K T"),
        ("", "archit", "", "AA R K AX T"),
        ("r", "achute", "", "AH0 SH UW2 T"),
        ("ub", "arb", "", "AA R B"),
        (" n", "ational", "", "AE SH AX N AX L"),
        (" r", "ational", "", "AE SH AX N AX L"),
        (" ", "april", "", "EY1 P R AH0 L"),
        (" ", "australia", "", "AO0 S T R EY1 L Y AH0"),
        (" ", "africa", "", "AE1 F R IH0 K AH0"),
        ("", "alley", "", "AE L IY"),
        ("", "ausage", "", "AO S IH JH"),
        (" ", "animal", "", "AE1 N AH0 M AH0 L"),
        (" ", "achiev", "", "AH0 CH IY1 V"),
        (" ", "anchor", "", "AE NG K ER"),
        ("s", "almon", "", "AE M AX N"),
        (" ", "although", "", "AO0 L DH OW1"),
        (" ", "alread", "", "AO0 L R EH1 D"),
        ("w", "a", "ter", "AO"),
        (" ", "antique", "", "AE0 N T IY1 K"),
        # unstressed final -ant after a syllable boundary (elephant,
        # distant, vacant, merchant); monosyllables (grant, plant) and
        # vowel-adjacent -iant (giant) keep the full vowel
        ("#:^", "ant", " ", "AX N T"),
        (" ", "among", "", "AX M AH NG"),
        ("f", "ather", " ", "AA DH ER"),
        ("f", "ather", "s ", "AA DH ER"),
        ("f", "ather", "ly", "AA DH ER"),
        ("", "achine", "", "AX SH IY N"),
        ("sw", "a", "p", "AA"),
        ("", "aign", "", "EY1 N"),
        (" ", "and", " ", "AX N D"),
        (" s", "ays", " ", "EH Z"),
        ("#r", "age", " ", "IH JH"),
        ("", "agne", " ", "EY N"),
        (" ", "answer", "", "AE N S ER"),
        (" ", "aisle", "", "AY L"),
        (" ", "ache", "", "EY K"),
        (" ", "a", " ", "AX"),
        (" ", "are", " ", "AA R"),
        (" ", "ar", "o", "AX R"),
        ("", "ar", "#", "EH R"),
        (" ^", "as", "#", "EY S"),
        ("", "a", "wa", "AX"),
        ("", "a", "gue ", "EY"),
        ("", "aw", "", "AO"),
        (" :", "any", "", "EH N IY"),
        ("", "a", "^+#", "EY"),
        ("#:", "ally", "", "AX L IY"),
        (" ", "al", "#", "AX L"),
        ("", "again", "", "AX G EH N"),
        ("#:", "ag", "e", "AX JH"),
        ("w", "a", "n", "AA"),
        ("w", "a", "sh", "AA"),
        ("qu", "a", "n", "AA"),
        ("qu", "a", "l", "AA"),
        ("qu", "a", "d", "AA"),
        ("", "a", "^+:#", "AE"),
        (" :", "a", "^+ ", "EY"),
        ("", "a", "^%", "EY"),
        (" ", "arr", "", "AX R"),
        ("", "arr", "", "AE R"),
        (" :", "ar", " ", "AA R"),
        ("", "ar", " ", "ER"),
        ("", "ar", "", "AA R"),
        ("", "air", "", "EH R"),
        ("", "ai", "", "EY"),
        ("", "ay", "", "EY"),
        (" l", "augh", "", "AE F"),
        ("", "au", "", "AO"),
        ("#:", "al", " ", "AX L"),
        ("#:", "als", " ", "AX L Z"),
        ("", "alf", " ", "AE F"),
        ("", "alm", " ", "AA M"),
        ("", "alm", "s", "AA M"),
        ("", "alk", "", "AO K"),
        (" ", "anticipat", "", "AE0 N T IH1 S AH0 P EY2 T"),
        # word-initial al- before b/c/f/g/p keeps the full AE vowel
        # (album, alcohol, alfalfa, algebra, alphabet); the adverbial
        # all- contractions (also, almost, already, although, alter)
        # stay AO — twenty-sixth probe band (science/education)
        (" ", "always", " ", "AO1 L W EY2 Z"),
        # all+front-vowel stem keeps AE (allergy, alley), unlike the
        # adverbial all- — twenty-seventh probe band
        (" ", "all", "erg", "AE L"),
        (" ", "appetite", "", "AE1 P AH0 T AY2 T"),
        (" ", "altitude", "", "AE1 L T AH0 T UW2 D"),
        (" ", "alphabet", "", "AE1 L F AH0 B EH2 T"),
        (" ", "al", "b", "AE L"),
        (" ", "al", "c", "AE L"),
        (" ", "al", "f", "AE L"),
        (" ", "al", "g", "AE L"),
        (" ", "al", "p", "AE L"),
        ("", "al", "^", "AO L"),
        (" :", "able", "", "EY B AX L"),
        ("", "able", "", "AX B AX L"),
        ("", "ang", "+", "EY N JH"),
        ("", "a", "", "AE"),
    ],
    "b": [
        # -borne compound finals (airborne, waterborne ... B AO2 R N);
        # the standalone participle keeps its primary — band R
        (" ", "borne", " ", "B AO1 R N"),
        ("", "borne", " ", "B AO2 R N"),
        (" ", "bluetooth", "", "B L UW1 T UW2 TH"),
        (" ", "brazil", "", "B R AH0 Z IH1 L"),
        # eyebrow keeps the full brow vowel (rainbow's -bow stays OW)
        ("#", "brow", " ", "B R AW2"),
        (" ", "bedroom", "", "B EH1 D R UW2 M"),
        # indefinite-pronoun second elements keep a full secondary
        # vowel (anybody, everybody); -board compounds keep AO2
        ("y", "body", " ", "B AA2 D IY0"),
        # -board compounds after a consonant or -y first element keep
        # AO2 (keyboard, cardboard); aboard (vowel left) stays AO1
        ("y", "board", " ", "B AO2 R D"),
        ("^", "board", " ", "B AO2 R D"),
        (" ", "beverage", "", "B EH1 V ER0 IH0 JH"),
        ("", "bage", " ", "B IH JH"),
        (" ", "bananas", " ", "B AH0 N AE1 N AH0 Z"),
        (" ", "banana", "", "B AH0 N AE1 N AH0"),
        (" ", "bouquet", "", "B UW0 K EY1"),
        (" ", "bury", "", "B EH1 R IY0"),
        (" ", "buried", "", "B EH1 R IY0 D"),
        (" ", "ballet", "", "B AE0 L EY1"),
        (" ", "bologna", "", "B AH0 L OW1 N IY0"),
        (" ", "bed", "", "B EH D"),
        (" ", "business", "", "B IH Z N AX S"),
        (" ", "busy", "", "B IH Z IY"),
        (" ", "been", " ", "B IH N"),
        ("", "bt", " ", "T"),
        ("", "bt", "s", "T"),
        (" ", "be", "^#", "B IH"),
        ("", "being", "", "B IY IH NG"),
        (" ", "both", " ", "B OW TH"),
        (" ", "bus", "#", "B IH Z"),
        ("", "buil", "", "B IH L"),
        ("", "bb", "", "B"),
        ("", "b", "", "B"),
    ],
    "c": [
        # -charge compounds keep the full verb root (discharge,
        # recharge, surcharge, overcharge) — forty-fifth probe band
        # (band M); bare "charge" keeps its primary via the
        # word-initial rule
        (" ", "charg", "", "CH AA1 R JH"),
        ("", "charg", "", "CH AA2 R JH"),
        # Greek ch reads K before the -itis suffix (bronchitis
        # B R AA0 NG K AY1 T IH0 S) — band Q
        ("", "chitis", " ", "K AY1 T IH0 S"),
        # Italian cch is a plain K (zucchini, gnocchi) — round-5 sweep
        ("", "cch", "", "K"),
        # Greek n+chol keeps the hard K (melancholy)
        ("n", "chol", "", "K AA2 L"),
        ("", "celer", "", "S EH1 L ER0"),
        (" ", "connoisseur", "", "K AA2 N AH0 S ER1"),
        # final -cove keeps the long O (alcove AE1 L K OW2 V, cove);
        # medial recover/discovery keep their AH via the boundary
        ("", "cove", " ", "K OW1 V"),
        ("", "coves", " ", "K OW1 V Z"),
        (" ", "croissant", "", "K R AH0 S AA1 N T"),
        # stressed compl- keeps AA (compliment, complicated), unlike
        # reduced com- (complete, complain) — twenty-sixth probe band
        (" ", "compl", "i", "K AA M P L"),
        (" ", "citizen", "", "S IH1 T AH0 Z AH0 N"),
        # sincere(ly) stresses the -cere syllable —
        # twenty-eighth probe band
        ("n", "cere", " ", "S IH1 R"),
        ("n", "cerel", "y", "S IH1 R L"),
        # final -cil reduces to S AH0 L (pencil, council, stencil) —
        # twenty-sixth probe band
        ("", "cil", " ", "S AH0 L"),
        ("", "cils", " ", "S AH0 L Z"),
        # Latinate -ciate verbs palatalize with a glide syllable
        # (appreciate, associate) — thirty-second probe band
        ("", "ciate", " ", "SH IY0 EY2 T"),
        ("", "ciated", " ", "SH IY0 EY2 T IH0 D"),
        ("", "ciates", " ", "SH IY0 EY2 T S"),
        ("", "ciating", " ", "SH IY0 EY2 T IH0 NG"),
        # "-ease" S-exceptions (the default voices final -ease as in
        # please/tease): cease, crease — twenty-third probe band
        (" ", "cease", "", "S IY S"),
        ("", "crease", "", "K R IY S"),
        (" ", "credit", " ", "K R EH1 D AH0 T"),
        (" ", "criminal", " ", "K R IH1 M AH0 N AH0 L"),
        (" ", "casual", " ", "K AE1 ZH AH0 W AH0 L"),
        (" ", "concert", "", "K AA1 N S ER0 T"),
        (" ", "catastrophe", "", "K AH0 T AE1 S T R AH0 F IY0"),
        (" ", "coyote", "", "K AY0 OW1 T IY0"),
        (" ", "cologne", "", "K AH0 L OW1 N"),
        # verbal -mute keeps final stress (commute, commuter) —
        # twenty-fifth probe band
        (" ", "commut", "", "K AH0 M Y UW1 T"),
        (" ", "clothes", " ", "K L OW1 DH Z"),
        (" ", "chassis", " ", "CH AE1 S IY0"),
        (" ", "chinese", "", "CH AY0 N IY1 Z"),
        (" ", "china", "", "CH AY1 N AH0"),
        (" ", "chaos", "", "K EY1 AA0 S"),
        (" ", "chron", "", "K R AA N"),
        (" ", "champagne", "", "SH AE0 M P EY1 N"),
        (" ", "chauffeur", "", "SH OW0 F ER1"),
        (" ", "chandelier", "", "SH AE2 N D AX L IH1 R"),
        (" ", "charade", "", "SH ER0 EY1 D"),
        (" ", "chemise", "", "SH AH0 M IY1 Z"),
        (" ", "cache", " ", "K AE1 SH"),
        (" ", "cafe", " ", "K AH0 F EY1"),
        (" ", "cliche", " ", "K L IY0 SH EY1"),
        (" ", "corps", " ", "K AO1 R"),
        (" ", "canoe", "", "K AH0 N UW1"),
        (" ", "chocolate", "", "CH AO1 K L AX T"),
        (" ", "choir", "", "K W AY1 ER0"),
        (" ", "companion", "", "K AH0 M P AE1 N Y AX N"),
        (" ", "clothing", "", "K L OW1 DH IH0 NG"),
        (" ", "cupboard", "", "K AH1 B ER0 D"),
        (" ", "compare", "", "K AH0 M P EH1 R"),
        (" ", "complain", "", "K AH0 M P L EY1 N"),
        (" ", "complete", "", "K AH0 M P L IY1 T"),
        (" ", "colonel", "", "K ER N AX L"),
        # French loan ending (crochet; hatchet/ratchet keep CH)
        ("o", "chet", " ", "SH EY"),
        (" ", "ch", "^", "K"),
        ("^e", "ch", "", "K"),
        ("", "ch", "r", "K"),
        ("e", "ch", "o", "K"),
        ("", "ch", "n", "K"),
        ("ma", "ch", " ", "K"),
        ("o", "ch", " ", "K"),
        ("", "chem", "", "K EH M"),
        ("", "charact", "", "K EH R IH K T"),
        (" ", "chor", "", "K AO R"),
        ("", "ch", "", "CH"),
        ("", "ccess", " ", "K S EH S"),
        ("", "cess", " ", "S EH S"),
        (" s", "ci", "#", "S AY"),
        ("", "ci", "a", "SH"),
        ("", "ci", "o", "SH"),
        ("", "ci", "en", "SH"),
        ("", "cc", "+", "K S"),
        ("", "cc", "", "K"),
        ("", "c", "+", "S"),
        ("", "ck", "", "K"),
        ("", "com", "%", "K AH M"),
        ("", "c", "", "K"),
    ],
    "d": [
        # final -dule palatalizes (module M AA1 JH UW0 L, schedule,
        # nodule) — round-5 CV sweep
        ("", "dule", " ", "JH UW0 L"),
        ("", "dules", " ", "JH UW0 L Z"),
        # ad- before j is a spelling geminate of one JH (adjust
        # AH0 JH AH1 S T, adjacent, adjourn, adjective)
        ("a", "dj", "", "JH"),
        # denim pre-empts the de- prefix digraph
        (" ", "denim", " ", "D EH1 N AX M"),
        # n+dulum palatalizes (pendulum P EH1 N JH AH0 L AH0 M)
        ("n", "dulum", " ", "JH AX L AX M"),
        (" ", "digit", "", "D IH1 JH AH0 T"),
        # the furniture drawer contracts to one syllable —
        # thirtieth probe band
        (" ", "drawer", "", "D R AO1 R"),
        (" ", "debit", " ", "D EH1 B IH0 T"),
        (" ", "decade", " ", "D EH1 K EY0 D"),
        (" ", "disease", " ", "D IH0 Z IY1 Z"),
        (" ", "definite", "", "D EH1 F AH0 N AH0 T"),
        (" ", "disappoint", "", "D IH2 S AH0 P OY1 N T"),
        (" ", "database", "", "D EY1 T AH0 B EY2 S"),
        (" ", "data", " ", "D EY1 T AH0"),
        (" ", "debris", "", "D AH0 B R IY1"),
        # device keeps the stressed AY against the reduced final-ice
        # rule; discipline keeps its reduced final syllable against
        # the -line rule — twenty-fourth probe band
        (" ", "device", " ", "D IH0 V AY1 S"),
        (" ", "devices", " ", "D IH0 V AY1 S IH0 Z"),
        (" ", "discipline", " ", "D IH1 S AH0 P L AH0 N"),
        (" ", "disciplines", " ", "D IH1 S AH0 P L AH0 N Z"),
        (" ", "detour", "", "D IY1 T UH0 R"),
        (" ", "depot", "", "D IY1 P OW0"),
        (" ", "delicious", "", "D IH0 L IH1 SH AH0 S"),
        (" ", "decorate", " ", "D EH1 K ER0 EY2 T"),
        (" ", "decorates", " ", "D EH1 K ER0 EY2 T S"),
        (" ", "decorated", " ", "D EH1 K ER0 EY2 T IH0 D"),
        (" ", "decorating", " ", "D EH1 K ER0 EY2 T IH0 NG"),
        (" ", "dia", "", "D AY AX"),
        ("", "dge", " ", "JH"),
        ("", "dges", " ", "JH IH Z"),
        ("n", "dred", "", "D R AX D"),
        ("we", "dnes", "", "N Z"),
        ("#:", "ded", " ", "D IH D"),
        (".e", "d", " ", "D"),
        ("#^:e", "d", " ", "T"),
        (" ", "de", "^#", "D IH"),
        (" ", "do", " ", "D UW"),
        (" ", "does", "", "D AH Z"),
        (" ", "doing", "", "D UW IH NG"),
        (" ", "dow", "", "D AW"),
        ("", "du", "a", "JH UW"),
        # soft g after d: "dg" before a front vowel reads JH with the
        # d silent (budget, gadget, widget, fidget, judged, budgie) —
        # twenty-third probe band (money/law/time)
        ("", "dg", "+", "JH"),
        ("", "dd", "", "D"),
        ("", "d", "", "D"),
    ],
    "e": [
        # silent b in the debt family (debt, debtor, indebted
        # ... EH T) — CV-error fix
        ("", "ebt", "", "EH T"),
        # silent-e stems before -dom (boredom B AO1 R D AH0 M);
        # freedom's ee is consumed earlier and never reaches this —
        # band X
        ("", "edom", " ", "D AH0 M"),
        # word-final -ees is a voiced plural/agent ending (degrees,
        # employees, referees ... IY1 Z) — sentence-audit fix, round 5
        ("", "ees", " ", "IY1 Z"),
        # embroider family keeps the em- prefix unstressed with the
        # diphthong primary (embroidery EH0 M B R OY1 D ER0 IY0) —
        # band M
        (" ", "embroid", "", "EH0 M B R OY1 D"),
        # -escent/-escence Latinate adjectives stress the suffix E
        # (adolescent AE2 D AH0 L EH1 S AH0 N T, crescent, iridescent,
        # effervescence); descent keeps its de- prefix via the
        # exceptions — band P
        (" d", "escent", " ", "IH0 S EH1 N T"),
        (" d", "escents", " ", "IH0 S EH1 N T S"),
        ("", "escents", " ", "EH1 S AX N T S"),
        ("", "escent", " ", "EH1 S AX N T"),
        ("", "escences", " ", "EH1 S AX N S IH0 Z"),
        ("", "escence", " ", "EH1 S AX N S"),
        # -eril(s) finals reduce like the -il family (peril
        # P EH1 R AH0 L); -erity abstract nouns reduce the suffix i
        # (austerity, sincerity, prosperity EH1 R AH0 T IY0) — the
        # older "eri" digraph rule would otherwise consume the e-r-i
        # before the i/r-bucket rules can see them — band O
        ("", "erils", " ", "EH R AX L Z"),
        ("", "eril", " ", "EH R AX L"),
        ("", "erities", " ", "EH R AX T IY Z"),
        ("", "erity", " ", "EH R AX T IY"),
        # -etitor/-etitive agents stress the antepenult (competitor
        # K AH0 M P EH1 T AH0 T ER0, competitive, repetitive); petition
        # spells -etition and keeps its own path — band O
        ("p", "etitor", "", "EH1 T AX T ER0"),
        ("p", "etitiv", "", "EH1 T AX T IH0 V"),
        # e in the open syllable before a -Cia(n/l) hiatus is long
        # (median M IY1 D IY0 AH0 N, comedian, bohemian,
        # encyclopedia) — forty-fourth probe band (band L)
        ("", "e", "^ia", "IY"),
        # unstressed -el after the K-S cluster of x reduces (pixel,
        # megapixel M EH1 G AH0 P IH2 K S AH0 L); excel's stressed EH
        # keeps its c left context — band L
        ("x", "el", " ", "AX L"),
        ("x", "els", " ", "AX L Z"),
        # -ency nominals destress the suffix so the stem takes primary
        # (decency D IY1 S AH0 N S IY0, frequency, tendency, currency);
        # the left vowel requirement keeps monosyllabic stems intact —
        # round-5 CV error-class sweep (fold analysis, not held-out)
        ("#:", "ency", " ", "AX N S IY0"),
        ("#:", "encies", " ", "AX N S IY0 Z"),
        # -emony parallels -imony (ceremony S EH1 R AH0 M OW2 N IY0)
        ("#:^", "emony", " ", "AX M OW2 N IY0"),
        # frequency/frequent keep the long open E (F R IY1 K W AH0 N T)
        ("r", "equen", "", "IY K W AX N"),
        # -estial palatalizes (celestial S AH0 L EH1 S CH AH0 L,
        # bestial)
        ("", "estial", " ", "EH1 S CH AX L"),
        # French -euver (maneuver M AH0 N UW1 V ER0)
        ("", "euver", "", "UW1 V ER0"),
        # sewage S UW1 AH0 JH (unlike sew S OW1)
        ("", "ewage", " ", "UW1 AH0 JH"),
        # chemical -ium nominals stress the open antepenult long
        # (helium HH IY1 L IY0 AH0 M, magnesium M AE0 G N IY1 Z IY0)
        ("", "elium", " ", "IY1 L IY0 AX M"),
        ("", "esium", " ", "IY1 Z IY0 AX M"),
        # final -eer is the stressed rhotic vowel in monosyllables and
        # agent nouns alike (beer B IH1 R, steer, career, volunteer)
        ("", "eer", " ", "IH1 R"),
        ("", "eers", " ", "IH1 R Z"),
        # Greek -eology keeps the hiatus (geology JH IY0 AA1 L AH0 JH,
        # theology, ideology) — round-5 CV sweep
        ("", "eolog", "", "IY0 AA1 L AX JH"),
        # regul- keeps the full EH (regulator R EH1 G Y AH0 L EY2 T,
        # regulate, regular)
        (" r", "egul", "", "EH1 G Y AX L"),
        # -ecise keeps the long I with final-root stress (precise,
        # precisely, imprecise)
        ("r", "ecise", "", "IH0 S AY1 S"),
        ("v", "eranda", "", "ER0 AE1 N D AH0"),
        ("", "ectoral", "", "EH1 K T ER0 AX L"),
        # pre-empts the "eri" digraph (peripheral P ER0 IH1 F ER0...)
        ("", "eripheral", "", "ER0 IH1 F ER0 AX L"),
        # Greek -enomen stems (phenomena F AH0 N AA1 M AH0 N AH0)
        ("", "enomen", "", "AX N AA1 M AX N"),
        ("", "erendum", "", "ER0 EH1 N D AX M"),
        ("", "eaucracy", "", "AA1 K R AX S IY0"),
        (" ", "entrepreneur", "", "AA2 N T R AH0 P R AH0 N ER1"),
        # French -oire/-oir keep the W (repertoire, reservoir)
        ("", "ertoire", "", "ER0 T W AA2 R"),
        ("", "ervoir", " ", "ER0 V W AA2 R"),
        ("rh", "etoric", "", "EH1 T ER0 IH0 K"),
        # French -elain reduces (porcelain P AO1 R S AH0 L AH0 N)
        ("", "elain", " ", "AX L AX N"),
        # unstressed -eled participles (beveled, modeled, labeled,
        # traveled, chiseled); a vowel before (heeled, fueled) fails
        # the consonant context — forty-first probe band (band I)
        ("#:^", "eled", " ", "AX L D"),
        # word-final -ere is the IH R rime (severe, adhere, interfere,
        # mere, premiere); there/where/were are lexicon words and the
        # -sphere compounds match the s-bucket rule first —
        # thirty-fifth probe band (band A)
        ("", "ere", " ", "IH R"),
        ("", "eres", " ", "IH R Z"),
        (" ", "emphasis", " ", "EH1 M F AH0 S IH0 S"),
        # equality destresses its e- against first-stress equal —
        # thirty-first probe band
        (" ", "equalit", "", "IH0 K W AA1 L AH0 T"),
        (" ", "equal", "", "IY1 K W AH0 L"),
        # open-syllable e before "-gal" (legal, regal; illegal via the
        # lexicon for its IH2 prefix) — twenty-third probe band
        ("", "egal", " ", "IY1 G AH0 L"),
        # Italian -enna penult stress (antenna, sienna) —
        # twenty-ninth probe band
        ("", "enna", " ", "EH1 N AH0"),
        (" ", "evidence", " ", "EH1 V AH0 D AH0 N S"),
        # silent stem-final e before the -less suffix (careless,
        # hopeless) — twenty-sixth probe band
        ("#^", "e", "less", ""),
        # e before -ciate tenses to IY (appreciate) —
        # thirty-second probe band
        ("r", "e", "ciat", "IY"),
        # Latinate agentive -erator keeps the long A (generator,
        # operator, refrigerator) — thirtieth probe band
        ("", "erator", " ", "ER0 EY2 T ER0"),
        ("", "erators", " ", "ER0 EY2 T ER0 Z"),
        # -eriment before the "eri" digraph rule (experiment) —
        # twenty-sixth probe band
        ("", "eriment", " ", "EH1 R AH0 M AH0 N T"),
        ("", "eriments", " ", "EH1 R AH0 M AH0 N T S"),
        # eras- stem covers erase/eraser/erasing/erased; bare initial
        # e+r+vowel reduces to IH R (erect, erode, erupt, erosion —
        # the destress itself is _prefix_destresses); era/Erie keep EH
        # because "#^" needs a consonant after the vowel —
        # twenty-sixth probe band
        (" ", "eras", "#", "IH0 R EY1 S"),
        (" ", "erase", " ", "IH0 R EY1 S"),
        (" ", "er", "#^", "IH R"),
        (" ", "escape", "", "IH0 S K EY1 P"),
        (" ", "eventual", "", "IH0 V EH1 N CH UW0 AH0 L"),
        (" ", "entire", "", "IH0 N T AY1 ER0"),
        (" ", "explanation", "", "EH2 K S P L AH0 N EY1 SH AH0 N"),
        (" ", "embarrass", "", "IH0 M B EH1 R AH0 S"),
        (" ", "etcetera", "", "EH2 T S EH1 T ER0 AH0"),
        (" ", "engineer", "", "EH2 N JH AH0 N IH1 R"),
        # occupations band (twenty-fourth probe): elect- family keeps
        # its IH0 L EH0 initial under -ician stress; employ- pins the
        # OY primary the em- prefix heuristics miss
        (" ", "electrician", "", "IH0 L EH0 K T R IH1 SH AH0 N"),
        (" ", "employee", "", "EH2 M P L OY1 IY0"),
        (" ", "employer", "", "EH0 M P L OY1 ER0"),
        (" ", "employ", "", "EH0 M P L OY1"),
        # wh+ever compounds with an OPEN first syllable carry their
        # exact CMU digits (the open pretonic would otherwise reduce
        # under the pinned-word rule) — round-5 band A
        (" wh", "enever", " ", "EH0 N EH1 V ER0"),
        (" wh", "erever", " ", "EH0 R EH1 V ER0"),
        # wh+ever / negated-ever compounds stress the second element
        # (whenever, wherever, whichever; never itself is N EH1 V ER0)
        ("n", "ever", " ", "EH1 V ER0"),
        ("r", "ever", " ", "EH1 V ER0"),
        ("ch", "ever", " ", "EH1 V ER0"),
        ("#:", "ered", " ", "ER D"),
        (" ", "especial", "", "AH0 S P EH1 SH AH0 L"),
        (" ", "enchant", "", "EH0 N CH AE1 N T"),
        (" r", "eally", "", "IH1 L IY0"),
        ("", "edicine", "", "EH D AX S AX N"),
        ("d", "esert", " ", "EH1 Z ER0 T"),
        ("d", "eserts", " ", "EH1 Z ER0 T S"),
        ("d", "essert", "", "IH0 Z ER1 T"),
        (" ", "eleven", "", "IH0 L EH1 V AX N"),
        ("x", "ecutive", "", "EH1 K Y AX T IH0 V"),
        (" r", "esignation", "", "EH2 Z IH0 G N EY1 SH AH0 N"),
        (" ", "electric", " ", "IH0 L EH1 K T R IH0 K"),
        # electr- stem words stressed on the stem (electrode, electron,
        # electrolyte); -onic derivatives keep the suffix-stress
        # heuristics via the word-final contexts — thirty-seventh
        # probe band (band C)
        (" ", "electrode", "", "IH0 L EH1 K T R OW2 D"),
        (" ", "electron", " ", "IH0 L EH1 K T R AA0 N"),
        (" ", "electrons", " ", "IH0 L EH1 K T R AA0 N Z"),
        (" ", "electroly", "", "IH0 L EH1 K T R AH0 L AY2"),
        (" ", "electrical", "", "IH0 L EH1 K T R IH0 K AH0 L"),
        (" ", "electricity", "", "IH0 L EH0 K T R IH1 S AH0 T IY0"),
        (" ", "electronic", "", "IH0 L EH2 K T R AA1 N IH0 K"),
        (" ", "electron", "", "IH0 L EH1 K T R AA2 N"),
        (" ", "election", "", "IH0 L EH1 K SH AH0 N"),
        (" ", "email", "", "IY1 M EY2 L"),
        (" ", "economic", "", "EH2 K AH0 N AA1 M IH0 K"),
        (" ", "econom", "", "IH0 K AA1 N AH0 M"),
        ("", "educ", "", "EH JH AH0 K"),
        (" ", "environment", "", "IH0 N V AY1 R AH0 N M AH0 N T"),
        (" ", "epitome", " ", "IH0 P IH1 T AH0 M IY0"),
        (" ", "enjoy", "", "EH0 N JH OY1"),
        (" ", "exercise", "", "EH1 K S ER0 S AY2 Z"),
        (" ", "enorm", "", "IH0 N AO1 R M"),
        ("", "e", "ri#", "IH"),
        (" ", "err", " ", "ER"),
        ("", "err", "", "EH R"),
        (" ", "encourag", "", "EH0 N K ER1 IH0 JH"),
        (" ", "everything", "", "EH1 V R IY0 TH IH2 NG"),
        (" ", "everyone", "", "EH1 V R IY0 W AH2 N"),
        (" ", "everybody", "", "EH1 V R IY0 B AA2 D IY0"),
        (" ", "everywhere", "", "EH1 V R IY0 W EH2 R"),
        (" ", "every", " ", "EH1 V ER0 IY0"),
        (" ", "every", "", "EH V R IY"),
        (" ", "evening", "", "IY V N IH NG"),
        (" ", "enough", "", "IH0 N AH1 F"),
        (" ", "european", "", "Y UH2 R AH0 P IY1 AH0 N"),
        (" ", "europ", "", "Y UH R AX P"),
        ("#^", "ean", " ", "IY AX N"),
        ("", "eign", "", "EY N"),
        ("sw", "eat", "", "EH T"),
        ("thr", "eat", "", "EH T"),
        ("h", "eight", "", "AY T"),
        ("l", "ettuce", "", "EH1 T AX S"),
        (" s", "enior", "", "IY1 N Y ER0"),
        ("#", "ence", " ", "AX N S"),
        ("#", "ences", " ", "AX N S IH Z"),
        ("#", "ent", " ", "AX N T"),
        ("#", "ents", " ", "AX N T S"),
        ("l", "evel", "", "EH V AX L"),
        ("pr", "etty", "", "IH T IY"),
        (" s", "everal", "", "EH V R AX L"),
        ("n", "ecessar", "", "EH S AX S EH R"),
        ("z", "ero", "", "IH R OW"),
        ("h", "ear", " ", "IY R"),
        ("h", "ear", "s ", "IY R"),
        ("h", "ear", "ing", "IY R"),
        (" r", "ead", " ", "IY D"),
        (" r", "ead", "s ", "IY D"),
        (" r", "ead", "ing", "IY D"),
        (" r", "ead", "er", "IY D"),
        # knead and the bead/plead class keep the tense vowel; wreath
        # too — round-5 final CV sweep
        (" kn", "ead", "", "IY D"),
        (" b", "ead", "", "IY D"),
        (" pl", "ead", "", "IY D"),
        (" wr", "eath", " ", "IY TH"),
        (" wr", "eaths", " ", "IY DH Z"),
        ("cr", "ea", "ture", "IY"),
        ("cr", "ea", "t", "IY0 EY1"),
        # the vowel after a silenced t (listen, fasten) is a schwa
        ("t", "ed", " ", "IH D"),
        ("d", "ed", " ", "IH D"),
        ("#st", "en", " ", "AX N"),
        ("#st", "en", "s ", "AX N"),
        ("#st", "en", "ed", "AX N"),
        ("#st", "en", "er", "AX N"),
        ("#st", "en", "ing", "AX N"),
        ("#:^", "ent", " ", "AX N T"),
        ("#:^", "ents", " ", "AX N T S"),
        ("#:^", "ence", " ", "AX N S"),
        ("#:^", "ences", " ", "AX N S IH Z"),
        (" ", "exh", "#", "IH G Z"),
        (" ", "ex", "#", "IH G Z"),
        (" ", "ex", "c", "IH K"),
        (" ", "ex", "^", "IH K S"),
        (" ", "engl", "", "IH NG G L"),
        (" ", "eighth", "", "EY T TH"),
        ("#:", "e", " ", ""),
        ("'^:", "e", " ", ""),
        (" :", "e", " ", "IY"),
        ("#", "ed", " ", "D"),
        ("#:", "e", "d ", ""),
        ("", "ev", "er", "EH V"),
        ("", "e", "^%", "IY"),
        ("", "erile", " ", "EH R AH0 L"),
        ("", "eri", "#", "IY R IY"),
        ("", "erica", "", "EH R AX K AX"),
        ("", "eri", "", "EH R IH"),
        ("#:", "er", "#", "ER"),
        ("", "er", "#", "EH R"),
        ("", "er", "", "ER"),
        (" ", "even", "", "IY V EH N"),
        ("#:", "e", "w", ""),
        ("@", "ew", "", "UW"),
        ("", "ew", "", "Y UW"),
        ("", "e", "o", "IY"),
        ("#:&", "es", " ", "IH Z"),
        ("#:", "e", "s ", ""),
        ("#:", "ely", " ", "L IY"),
        ("#:", "ement", "", "M EH N T"),
        ("", "eful", "", "F AX L"),
        ("", "eer", "", "IH R"),
        ("", "ee", "", "IY"),
        ("b", "eau", "", "Y UW"),
        ("", "eau", "", "OW"),
        ("", "earn", "", "ER N"),
        (" ", "ear", "^", "ER"),
        ("h", "ear", "t", "AA R"),
        ("b", "ear", "d", "IH R"),
        ("b", "ear", "", "EH R"),
        ("w", "ear", "", "EH R"),
        ("", "ear", "s ", "IH R"),
        ("", "ear", "^", "ER"),
        ("", "ear", "", "IH R"),
        ("", "ead", "", "EH D"),
        ("#:", "ea", " ", "IY AX"),
        ("", "ea", "su", "EH"),
        ("", "ealth", "", "EH L TH"),
        ("", "easant", "", "EH Z AX N T"),
        ("", "eakf", "", "EH K F"),
        ("", "eant", " ", "EH N T"),
        ("", "eal", "ou", "EH L"),
        (" ^^", "east", "", "EH S T"),
        ("", "ealm", "", "EH L M"),
        ("", "ealt", "", "EH L T"),
        ("", "eath", " ", "EH TH"),
        ("", "eather", "", "EH DH ER"),
        ("", "eaven", "", "EH V AX N"),
        ("", "eavy", "", "EH V IY"),
        ("", "ea", "", "IY"),
        (" ^", "eign", "", "EY N"),
        ("", "eipt", "", "IY T"),
        ("", "eigh", "", "EY"),
        ("", "ei", "", "IY"),
        (" ", "eye", "", "AY"),
        ("", "ey", "", "IY"),
        ("", "eu", "", "Y UW"),
        ("", "e", "", "EH"),
    ],
    "f": [
        # -fly insect/compound finals keep the diphthong (dragonfly,
        # butterfly, mayfly); -ly adverbs (briefly, chiefly) are
        # excluded by the consonant/ay left contexts — band N
        ("^", "fly", " ", "F L AY2"),
        ("ay", "fly", " ", "F L AY2"),
        # -ficient adjectives palatalize and take penult stress
        # (efficient IH0 F IH1 SH AH0 N T, sufficient, proficient;
        # the ff of efficient degeminates in the post-pass)
        ("", "ficien", "", "F IH1 SH AX N"),
        (" ", "fever", "", "F IY1 V ER0"),
        (" ", "fatal", " ", "F EY1 T AH0 L"),
        (" ", "fortunate", "", "F AO1 R CH AH0 N AH0 T"),
        (" ", "fortune", "", "F AO1 R CH AH0 N"),
        (" ", "finale", "", "F IH0 N AE1 L IY0"),
        (" ", "forgotten", "", "F ER0 G AA1 T AH0 N"),
        (" ", "forgot", "", "F ER0 G AA1 T"),
        (" ", "forget", "", "F ER0 G EH1 T"),
        (" ", "familiar", "", "F AH0 M IH1 L Y ER0"),
        (" ", "fatigue", "", "F AH0 T IY1 G"),
        (" ", "fiance", "", "F IY0 AA1 N S EY2"),
        (" ", "forehead", "", "F AO1 R HH EH2 D"),
        ("o", "ffice", " ", "F AX S"),
        (" ", "february", "", "F EH B Y AX W EH R IY"),
        # French loan ending (buffet; the doubled f degeminates)
        ("", "ffet", " ", "F EY"),
        # the word "full(y)" keeps UH; the -ful(ly) adjective suffix
        # reduces to a schwa in CMU (beautiful, wonderful, carefully)
        (" ", "full", "", "F UH L"),
        ("", "fully", " ", "F AX L IY"),
        ("", "ful", " ", "F AX L"),
        ("", "ful", "", "F UH L"),
        ("", "ff", "", "F"),
        ("", "f", "", "F"),
    ],
    "g": [
        # -ease S-exception (see "cease") — twenty-third probe band
        (" ", "grease", "", "G R IY S"),
        (" ", "grateful", "", "G R EY1 T F AH0 L"),
        (" ", "giant", "", "JH AY1 AH0 N T"),
        (" ", "guitar", "", "G IH0 T AA1 R"),
        (" ", "guinea", " ", "G IH1 N IY0"),
        ("", "gineer", "", "JH AX N IH1 R"),
        (" ", "grotesque", "", "G R OW0 T EH1 S K"),
        (" ", "germany", "", "JH ER1 M AH0 N IY0"),
        (" ", "garage", "", "G ER0 AA1 ZH"),
        ("", "geous", " ", "JH AX S"),
        # final -geon is a reduced JH syllable (surgeon, pigeon,
        # dungeon, sturgeon) — twenty-fourth probe band
        ("", "geon", " ", "JH AX N"),
        ("", "geons", " ", "JH AX N Z"),
        (" ", "gasoline", " ", "G AE1 S AH0 L IY2 N"),
        (" ", "genre", "", "ZH AA1 N R AH0"),
        (" ", "ginger", "", "JH IH1 N JH ER0"),
        (" ", "gentle", "", "JH EH1 N T AX L"),
        (" ", "gn", "", "N"),
        ("", "gm", " ", "M"),
        (" ", "gh", "", "G"),
        ("", "giv", "", "G IH V"),
        # -gitude softens before the reduced linking i (longitude
        # L AA1 N JH AH0 T UW2 D); "bargain" reduces its final
        ("", "gitude", " ", "JH AX T UW2 D"),
        ("ar", "gain", " ", "G AX N"),
        # final -igan reduces (cardigan, hooligan, Michigan)
        ("i", "gan", " ", "G AX N"),
        ("i", "gans", " ", "G AX N Z"),
        # -geant/-geance keep the soft g with a reduced vowel
        # (sergeant S AA1 R JH AH0 N T, pageant, vengeance); any other
        # g before "ea" is hard (gear, geese via "ee") — round-5 CV
        ("", "geant", "", "JH AX N T"),
        ("", "geance", "", "JH AX N S"),
        ("", "g", "ea", "G"),
        (" ", "g", "i^", "G"),
        ("", "ge", "t", "G EH"),
        ("su", "gges", "", "G JH EH S"),
        ("", "gg", "", "G"),
        (" b#", "g", "", "G"),
        ("", "g", "+", "JH"),
        ("", "great", "", "G R EY T"),
        ("#", "gh", "", ""),
        ("", "g", "", "G"),
    ],
    "h": [
        # -hood abstract-noun suffix carries a secondary (neighborhood,
        # parenthood ... HH UH2 D); standalone "hood" keeps primary —
        # band X
        (" ", "hood", " ", "HH UH1 D"),
        (" ", "hoods", " ", "HH UH1 D Z"),
        ("", "hood", " ", "HH UH2 D"),
        ("", "hoods", " ", "HH UH2 D Z"),
        # silent h in French -lhouette (silhouette S IH2 L UW0 EH1 T)
        ("l", "houette", "", "UW0 EH1 T"),
        # heredity family pre-empts the "here" adverb's long E
        (" ", "heredit", "", "HH ER0 EH1 D AX T"),
        # Greek hydr- keeps the long I (hydrogen, hydrant, hydraulic)
        # — thirty-sixth probe band (band B)
        ("", "hydr", "", "HH AY D R"),
        # home- compound prefix keeps the magic-e OW before another
        # consonant+vowel part (homework, homesick, hometown,
        # homemade, homeless) — twenty-sixth probe band
        (" ", "homesick", "", "HH OW1 M S IH2 K"),
        (" ", "home", "^#", "HH OW1 M"),
        (" ", "hyperbole", "", "HH AY0 P ER1 B AH0 L IY0"),
        (" ", "hello", "", "HH AX L OW"),
        (" ", "hors", " ", "AO1 R"),
        (" ", "hotel", "", "HH OW0 T EH1 L"),
        (" ", "however", "", "HH AW2 EH1 V ER0"),
        (" ", "herb", "", "ER B"),
        (" ", "hav", "", "HH AE V"),
        (" ", "here", "", "HH IY R"),
        (" ", "hour", "", "AW ER"),
        # silent-h family (honest, honor/honour, heir): the h is mute
        # and the o is the full AA vowel (CMU: AA1 N AH0 S T ...)
        (" ", "hon", "est", "AA N"),
        (" ", "honor", "", "AA N ER"),
        (" ", "honour", "", "AA N ER"),
        (" ", "heir", "", "EH R"),
        ("", "how", "", "HH AW"),
        ("", "h", "#", "HH"),
        ("", "h", "", ""),
    ],
    "i": [
        # -lihood nouns keep the base -ly adjective's tense vowel
        # (livelihood L AY1 V L IY0 HH UH2 D, likelihood)
        ("l", "ivelihood", " ", "AY1 V L IY0 HH UH2 D"),
        ("l", "ikelihood", " ", "AY1 K L IY0 HH UH2 D"),
        # -itious adjectives stress the suffix I (nutritious,
        # fictitious, superstitious ... IH1 SH AH0 S) — band S
        ("", "itious", "", "IH1 SH AX S"),
        # -itis medical nouns stress the long I (bronchitis,
        # arthritis, tendinitis ... AY1 T IH0 S) — band Q; the Greek
        # ch->K variant (bronchitis) lives in the c bucket
        ("", "itis", " ", "AY1 T IH0 S"),
        # -ify verb family keeps the diphthong suffix (clarify
        # K L EH1 R AH0 F AY2, dignify, falsify, mystify) — band P
        ("", "ifying", " ", "AX F AY2 IH0 NG"),
        ("", "ifies", " ", "AX F AY2 Z"),
        ("", "ified", " ", "AX F AY2 D"),
        ("", "ify", " ", "AX F AY2"),
        # -iology medical/science compounds read the linking i as IY0
        # (cardiology, radiology, sociology); biology's bi- prefix
        # keeps its diphthong via the exception — band P
        (" b", "iolog", "", "AY0 AA1 L AX JH"),
        ("", "iolog", "", "IY0 AA1 L AX JH"),
        # polysyllabic final -il reduces (anvil, tendril, fossil,
        # pencil, nostril AE1 N V AH0 L); stressed -il words (until,
        # Brazil) are lexicon entries — band O
        ("#:^", "il", " ", "AX L"),
        ("#:^", "ils", " ", "AX L Z"),
        # d+u palatalization in -iduous adjectives (deciduous
        # D IH0 S IH1 JH UW0 AH0 S, assiduous) — band O
        ("", "iduous", "", "IH1 JH UW0 AH0 S"),
        # monosyllabic -ire reads the syllabic CMU form (fire
        # F AY1 ER0, hire, spire); polysyllables keep their own paths
        # (admire AY R vs desire AY ER0 is lexical) — CV-error fix
        (" :", "ire", " ", "AY1 ER0"),
        (" :", "ires", " ", "AY1 ER0 Z"),
        (" :", "ired", " ", "AY1 ER0 D"),
        # monosyllabic y-stem plurals/verbs read the diphthong (flies,
        # tries, skies F L AY1 Z); polysyllables (babies, cities) have
        # a vowel before the onset so the boundary+consonants context
        # excludes them — band N
        (" :", "ies", " ", "AY1 Z"),
        # -ism nominals: secondary on the suffix + epenthetic schwa
        # (tourism T UH1 R IH2 Z AH0 M, criticism, organism); the left
        # context requires an earlier vowel so prism/schism keep their
        # primary — thirty-fifth probe band (band A)
        ("#:", "ism", " ", "IH2 Z AX M"),
        ("#:", "isms", " ", "IH2 Z AX M Z"),
        # unstressed i between a consonant and word-final -on/-um/-us
        # is the IY0 hiatus (champion, stadium, radius); after n/l the
        # glide fuses instead (union Y UW1 N Y AH0 N, million,
        # genius) — the n/l rules must precede the generic-consonant
        # ones within this first-match bucket — thirty-sixth probe
        # band (band B)
        ("n", "ion", " ", "Y AX N"),
        ("n", "ions", " ", "Y AX N Z"),
        ("l", "ion", " ", "Y AX N"),
        ("l", "ions", " ", "Y AX N Z"),
        ("n", "ium", " ", "Y AX M"),
        ("n", "ius", " ", "Y AX S"),
        # -ian hiatus parallels -ion/-ium (custodian
        # K AH0 S T OW1 D IY0 AH0 N, guardian, meridian); the same n/l
        # glide fusion applies (civilian S AH0 V IH1 L Y AH0 N), and
        # s+ian palatalizes (asian EY1 ZH AH0 N, persian, parisian) —
        # forty-fourth probe band (band L)
        ("n", "ian", " ", "Y AX N"),
        ("n", "ians", " ", "Y AX N Z"),
        ("l", "ian", " ", "Y AX N"),
        ("l", "ians", " ", "Y AX N Z"),
        ("#:^", "ian", " ", "IY0 AX N"),
        ("#:^", "ians", " ", "IY0 AX N Z"),
        # final -ia hiatus (media M IY1 D IY0 AH0, india, trivia,
        # encyclopedia); s+ia palatalizes in the s bucket (asia,
        # amnesia) — band L
        ("#:^", "ia", " ", "IY0 AH0"),
        ("#:^", "ias", " ", "IY0 AH0 Z"),
        ("#:^", "ion", " ", "IY0 AX N"),
        ("#:^", "ions", " ", "IY0 AX N Z"),
        ("#:^", "ium", " ", "IY0 AX M"),
        ("#:^", "iums", " ", "IY0 AX M Z"),
        ("#:^", "ius", " ", "IY0 AX S"),
        # word-initial iso- keeps the long I (isotope, isolate) —
        # thirty-sixth probe band
        (" ", "iso", "^", "AY S AH0"),
        # -ival after a liquid/fricative stem consonant is the -ive
        # stem's long I (arrival, survival, revival); festival and
        # carnival keep the short i via their t/n left contexts
        ("r", "ival", " ", "AY V AX L"),
        ("v", "ival", " ", "AY V AX L"),
        ("r", "ivals", " ", "AY V AX L Z"),
        ("v", "ivals", " ", "AY V AX L Z"),
        # Latinate -iC+ation nominals reduce the linking i to schwa and
        # the -ation suffix takes primary (application
        # AE2 P L AH0 K EY1 SH AH0 N, nomination, navigation,
        # invitation, distillation, pollinating) — round-5 CV
        # error-class sweep (fold analysis, not held-out)
        ("", "ication", "", "AX K EY1 SH AX N"),
        ("", "ination", "", "AX N EY1 SH AX N"),
        ("", "igation", "", "AX G EY1 SH AX N"),
        # ... -itation keeps IH0 after v (invitation, gravitation,
        # levitation) and reduces elsewhere (meditation, imitation)
        ("v", "itation", "", "IH0 T EY1 SH AX N"),
        ("", "itation", "", "AX T EY1 SH AX N"),
        ("", "illation", "", "AX L EY1 SH AX N"),
        # single-l -ilation after a syllable reduces too (ventilation,
        # compilation); word-initial dilation keeps its long I via the
        # left-vowel requirement
        ("#:^", "ilation", "", "AX L EY1 SH AX N"),
        # ... and the verb forms (-inate/-inating keep a secondary on
        # the -ate; germinate JH ER1 M AH0 N EY2 T, pollinate)
        ("#:^", "inate", "", "AX N EY2 T"),
        ("#:^", "inati", "ng", "AX N EY2 T IH"),
        # -imony parallels -emony with the linking i reduced
        # (testimony T EH1 S T AH0 M OW2 N IY0, matrimony, alimony)
        ("", "imony", " ", "AX M OW2 N IY0"),
        # Latinate -itude reduces the linking i with a secondary on the
        # suffix (attitude AE1 T AH0 T UW2 D, gratitude, solitude)
        ("", "itude", " ", "AX T UW2 D"),
        ("", "itudes", " ", "AX T UW2 D Z"),
        ("", "iculum", " ", "IH1 K Y AX L AX M"),
        ("", "inolog", "", "AX N AA1 L AX JH"),
        ("n", "insula", "", "IH1 N S AX L AH0"),
        # these pins pre-empt the digraph rules ("in", "eri", "ide")
        # that would otherwise consume their onsets
        (" ", "integral", "", "IH1 N T AX G R AX L"),
        (" ", "ideolog", "", "AY2 D IY0 AA1 L AX JH"),
        # Greek dino- keeps the long I (dinosaur)
        (" d", "ino", "", "AY N AH0"),
        # finish keeps the short I against the magic-e-like -ish read
        ("f", "inish", "", "IH1 N IH0 SH"),
        # hiatus i before the -ator suffix (radiator
        # R EY1 D IY0 EY2 T ER0, aviator, gladiator)
        ("", "i", "ato", "IY0"),
        ("", "ilemma", "", "AX L EH1 M AH0"),
        ("", "imatum", " ", "AX M EY1 T AX M"),
        ("", "itiative", "", "IH1 SH AX T IH0 V"),
        # hier- keeps the long I hiatus (hierarchy HH AY1 ER0 AA2 R K)
        ("", "ierarch", "", "AY ER0 AA2 R K"),
        # Greek -iatry/-iatrist stress the long I (psychiatry
        # S AH0 K AY1 AH0 T R IY0, podiatry)
        ("", "iatry", " ", "AY1 AX T R IY0"),
        ("", "iatrist", "", "AY1 AX T R IH0 S T"),
        # -inous/-imous adjectives reduce both suffix vowels (ominous
        # AA1 M AH0 N AH0 S, luminous, unanimous)
        ("", "inous", " ", "AX N AX S"),
        ("", "imous", " ", "AX M AX S"),
        # linking i before -mosity (animosity AE2 N AH0 M AA1 S...)
        ("", "i", "mosit", "AX"),
        # -icult(y) reduces the i (difficult D IH1 F AH0 K AH0 L T)
        ("", "icult", "", "AX K AX L T"),
        # -ilance/-ilant reduce (vigilance V IH1 JH AH0 L AH0 N S)
        ("", "ilan", "^", "AX L AX N"),
        # vowel+iage compresses to IH0 JH (carriage, marriage,
        # foliage F OW1 L IH0 JH)
        ("", "iage", " ", "IH0 JH"),
        ("", "iages", " ", "IH0 JH IH0 Z"),
        # -idal keeps the stem's long I (tidal, bridal, suicidal)
        ("", "idal", " ", "AY D AX L"),
        # -bine nouns keep the long I (turbine T ER1 B AY0 N, combine,
        # carbine); engine's g-context rule precedes in its own bucket
        ("b", "ine", " ", "AY N"),
        # final -ier after a word-initial consonant is the rhotic
        # monosyllable (pier, tier)
        (" ^", "ier", " ", "IH1 R"),
        (" ^", "iers", " ", "IH1 R Z"),
        # Latin-plural -bi keeps AY (alibi, rabbi); other final
        # unstressed -i loans read IY0 (taxi, chili, bikini)
        ("b", "i", " ", "AY2"),
        ("#:^", "i", " ", "IY0"),
        # -ierce monosyllables (fierce, pierce) —
        # twenty-eighth probe band
        ("", "ierce", " ", "IH1 R S"),
        (" ", "interrupt", "", "IH2 N T ER0 AH1 P T"),
        # -icy nominal suffix reduces (policy, delicacy-family) —
        # thirty-first probe band
        ("l", "icy", " ", "AH0 S IY0"),
        ("l", "icies", " ", "AH0 S IY0 Z"),
        # -it-ut- Latinate stems reduce the first i (constitution,
        # institute, substitution) — thirty-first probe band
        ("t", "it", "ut", "AH0 T"),
        (" ", "immigrant", "", "IH1 M AH0 G R AH0 N T"),
        (" ", "immigrati", "", "IH2 M AH0 G R EY1 SH"),
        # Latinate -iment nouns reduce the i (sediment, compliment,
        # regiment, experiment, condiment) — twenty-sixth probe band
        ("", "iment", " ", "AH0 M AH0 N T"),
        ("", "iments", " ", "AH0 M AH0 N T S"),
        (" ", "immediate", "", "IH0 M IY1 D IY0 AH0 T"),
        (" ", "introduc", "e", "IH2 N T R AH0 D UW1 S"),
        (" ", "ingredient", "", "IH0 N G R IY1 D IY0 AH0 N T"),
        (" ", "insect", "", "IH1 N S EH2 K T"),
        (" ", "internet", "", "IH1 N T ER0 N EH2 T"),
        (" ", "interview", "", "IH1 N T ER0 V Y UW2"),
        # license family keeps its magic-e AY across the -ense coda —
        # twenty-fifth probe band
        ("l", "icenses", " ", "AY1 S AH0 N S IH0 Z"),
        ("l", "icensed", " ", "AY1 S AH0 N S T"),
        ("l", "icense", " ", "AY1 S AH0 N S"),
        # agentive -itor reduces (janitor, monitor, editor, visitor);
        # suitor is consumed earlier at its ui digraph — 24th band
        ("", "itor", " ", "AX T ER"),
        ("", "itors", " ", "AX T ER Z"),
        # t+ire is the AY ER family everywhere (tire, retire,
        # retirement, satire, attire) — twenty-fourth probe band
        ("t", "ire", "", "AY ER"),
        # unstressed final -ice reduces to AH0 S in CMU (practice,
        # service, notice, apprentice); vowel-less onsets (twice,
        # slice, price) fall through to the magic-e rules
        ("#:^", "ice", " ", "AX S"),
        ("#:^", "ices", " ", "AX S IH0 Z"),
        # nn blocks the in- prefix's destress: the first syllable keeps
        # primary (innocent, innovate, inner, inning; innovation keeps
        # its -ation primary via the suffix rule) — twenty-third band
        (" ", "innocen", "", "IH1 N AH0 S AH0 N"),
        (" ", "innovat", "e", "IH1 N AH0 V EY2 T"),
        (" ", "illegal", " ", "IH2 L IY1 G AH0 L"),
        # word-final -ile: US English keeps AY2 L in nouns after
        # t-clusters / -file / -dile / -nile (reptile, textile,
        # percentile, profile, crocodile, juvenile) and reduces the
        # common Latinate adjectives to AH0 L (fragile, missile,
        # hostile, fertile, sterile, futile); monosyllables (mile,
        # while, smile) have no vowel before the cluster and fall
        # through to the magic-e rules
        # strong-verb participle -isen (risen, arisen)
        ("", "isen", " ", "IH Z AX N"),
        ("pt", "ile", " ", "AY2 L"),
        ("xt", "ile", " ", "AY2 L"),
        ("nt", "ile", " ", "AY2 L"),
        ("rof", "ile", " ", "AY2 L"),
        ("od", "ile", " ", "AY2 L"),
        ("en", "ile", " ", "AY2 L"),
        ("x", "ile", " ", "AY L"),
        ("mp", "ile", " ", "AY L"),
        ("#:^", "ile", " ", "AH0 L"),
        ("n", "ior", " ", "Y ER"),
        ("n", "iors", " ", "Y ER Z"),
        ("s", "ing", "er", "IH NG"),
        ("s", "ire", " ", "AY ER"),
        ("s", "ired", " ", "AY ER D"),
        ("s", "ires", " ", "AY ER Z"),
        ("", "indict", "", "IH N D AY T"),
        ("", "igm", " ", "AY M"),
        (" r", "iver", "", "IH V ER"),
        ("w", "i", "ndow", "IH"),
        (" ", "internation", "", "IH2 N T ER0 N AE1 SH AH0 N"),
        ("", "ization", "", "AX Z EY SH AX N"),
        ("#:", "iest", " ", "IY AX S T"),
        ("scr", "ibe", "", "AY B"),
        (" b", "i", "o", "AY"),
        ("", "ieth", " ", "IY AX TH"),
        (" n", "i", "nth", "AY"),
        ("b", "icycle", "", "AY S IH K AX L"),
        ("un", "i", "vers", "AX"),
        ("m", "irror", "", "IH R ER"),
        ("r", "i", "ous", "IY"),
        (" ", "india", "", "IH1 N D IY0 AH0"),
        (" ", "imagine", "", "IH0 M AE1 JH AH0 N"),
        (" ", "interest", "", "IH1 N T R AX S T"),
        (" cl", "imb", "", "AY M"),
        ("", "ield", "", "IY L D"),
        ("#:", "i", "ties", "AX"),
        ("#:", "i", "ty ", "AX"),
        ("", "ies", " ", "IY Z"),
        ("", "i", "ties", "IH"),
        ("", "i", "ty ", "IH"),
        ("v", "isit", "", "IH1 Z AX T"),
        ("v", "iolen", "", "AY AX L AX N"),
        ("l", "ibrar", "", "AY1 B R EH2 R"),
        ("sc", "issors", "", "IH Z ER Z"),
        ("ch", "ildren", "", "IH L D R AX N"),
        ("rr", "ive", "", "AY V"),
        ("fr", "ie", "nd", "EH"),
        # post-consonantal yod in weak "ia"/"ior" after l/n when an
        # earlier vowel exists (million, brilliant, familiar, junior;
        # word-initial li-/ni- keep the full vowel: liar, diary)
        ("#:l", "ia", "", "Y AX"),
        ("#:n", "io", "r", "Y"),
        (" ", "iron", "", "AY ER N"),
        ("", "iage", " ", "IH JH"),
        ("#:^", "ity", " ", "AX T IY"),
        ("#:^", "ities", " ", "AX T IY Z"),
        ("#:^", "ily", " ", "AX L IY"),
        ("", "ible", " ", "AX B AX L"),
        ("", "ibly", " ", "AX B L IY"),
        ("", "ilar", "", "AX L ER"),
        ("", "istry", "", "AX S T R IY"),
        # polysyllables only (determine, examine, engine, margin-class
        # -gine); the monosyllables mine/dine keep the diphthong via
        # the boundary-anchored exceptions
        (" m", "ine", " ", "AY1 N"),
        (" m", "ines", " ", "AY1 N Z"),
        (" m", "ined", " ", "AY1 N D"),
        ("m", "ine", " ", "AX N"),
        ("g", "ine", " ", "AX N"),
        (" ", "isl", "", "AY L"),
        (" ", "idea", "", "AY D IY AX"),
        (" ", "ide", "", "AY D"),
        ("", "i", "ke ", "AY"),
        ("", "i", "me ", "AY"),
        ("", "i", "mes ", "AY"),
        ("", "i", "gue ", "IY"),
        (" ", "in", "", "IH N"),
        (" ", "i", " ", "AY"),
        ("^l", "ion", "", "Y AX N"),
        ("#n", "ion", "", "Y AX N"),
        ("t", "ive", " ", "IH V"),
        ("s", "ive", " ", "IH V"),
        ("", "ive", " ", "AY V"),
        ("", "ide", " ", "AY D"),
        ("", "in", "d", "AY N"),
        ("", "iour", "", "Y ER"),
        ("v", "ior", "", "Y ER"),
        ("", "ier", "", "IY ER"),
        ("#:r", "ied", " ", "IY D"),
        ("", "ied", " ", "AY D"),
        ("", "ien", "", "IY EH N"),
        ("", "ie", "t", "AY EH"),
        ("", "ie", "^%", "IY"),
        # x spells the K-S cluster, so a preceding i is checked/short
        # (pixel, mixer, vixen) — the magic-e heuristics below would
        # otherwise read the single letter as an open syllable —
        # forty-fourth probe band (band L)
        ("", "i", "x", "IH"),
        (" :", "i", "%", "AY"),
        ("", "i", "%", "IY"),
        ("", "ie", "", "IY"),
        ("", "i", "^+:#", "IH"),
        ("", "ir", "#", "AY R"),
        ("", "iz", "%", "AY Z"),
        ("", "is", "%", "AY Z"),
        ("", "i", "d%", "AY"),
        ("+^", "i", "^+", "IH"),
        ("", "i", "t%", "AY"),
        ("#^:", "i", "^+", "IH"),
        ("", "i", "^+", "AY"),
        ("", "ir", "", "ER"),
        ("", "igh", "", "AY"),
        ("", "ild", "", "AY L D"),
        ("", "ign", " ", "AY N"),
        ("", "ign", "^", "AY N"),
        ("", "ign", "%", "AY N"),
        ("", "ique", "", "IY K"),
        ("", "i", "", "IH"),
    ],
    "j": [
        # noun-final -ject after b/o keeps an unreduced EH0 (subject,
        # object, project); verb stress (reject, inject, eject) is
        # unaffected — twenty-sixth probe band
        ("b", "ject", " ", "JH EH0 K T"),
        ("b", "ject", "s ", "JH EH0 K T"),
        ("o", "ject", " ", "JH EH0 K T"),
        ("o", "ject", "s ", "JH EH0 K T"),
        (" ", "july", " ", "JH UW0 L AY1"),
        # ju+r keeps the tense back vowel with no Y glide (jury, juror)
        (" ", "jur", "", "JH UH1 R"),
        # non-initial -jur- reduces (injury, injure, conjure,
        # perjury) — twenty-seventh probe band
        ("", "jur", "y", "JH ER0"),
        ("", "jur", "e", "JH ER0"),
        ("", "jur", "i", "JH ER0"),
        (" ", "justice", " ", "JH AH1 S T AH0 S"),
        (" ", "japanese", "", "JH AE2 P AH0 N IY1 Z"),
        (" ", "japan", "", "JH AH0 P AE1 N"),
        ("", "j", "", "JH"),
    ],
    "k": [
        # -keeper agent compounds carry a secondary (storekeeper,
        # gatekeeper, bookkeeper ... K IY2 P ER0) — band R
        ("^", "keeper", "", "K IY2 P ER0"),
        (" ", "korea", "", "K ER0 IY1 AH0"),
        (" ", "karate", "", "K ER0 AA1 T IY0"),
        ("er", "kin", " ", "K AX N"),
        (" ", "k", "n", ""),
        ("", "kk", "", "K"),
        ("", "k", "", "K"),
    ],

    "l": [
        (" ", "liaison", "", "L IY0 EY1 Z AA2 N"),
        # -ease S-exceptions: lease/release (please keeps the voiced
        # default via its 'p' left context) — twenty-third probe band
        (" ", "lease", "", "L IY S"),
        ("re", "lease", "", "L IY S"),
        (" ", "lawyer", " ", "L AO1 Y ER0"),
        (" ", "limit", " ", "L IH1 M AH0 T"),
        (" ", "luxur", "y", "L AH1 G ZH ER0"),
        (" ", "lieutenant", "", "L UW0 T EH1 N AX N T"),
        ("ow", "ledge", "", "L IH0 JH"),
        # -less suffix schwa after a stem (homeless, careless,
        # endless); bless/unless unaffected — twenty-sixth probe band
        ("#:", "less", " ", "L AX S"),
        # the o of laborat- syncopates (laboratory, laboratories) —
        # twenty-sixth probe band
        (" ", "laborator", "", "L AE1 B R AH0 T AO2 R"),
        ("", "llege", " ", "L IH JH"),
        ("", "lleges", " ", "L IH JH IH Z"),
        ("t", "less", " ", "L AX S"),
        ("d", "less", " ", "L AX S"),
        # final -line: AY in compounds and -cline verbs (deadline,
        # airline, decline, feline); the -oline loans keep IY (gasoline,
        # trampoline) — twenty-fourth probe band
        ("o", "line", " ", "L IY2 N"),
        ("o", "lines", " ", "L IY2 N Z"),
        ("", "line", " ", "L AY N"),
        ("", "lines", " ", "L AY N Z"),
        # -ling diminutives/gerunds keep the plain L (seedling,
        # sapling, darling, dumpling) against syllabic-le insertion —
        # thirty-sixth probe band (band B)
        ("^", "ling", " ", "L IH0 NG"),
        ("^", "lings", " ", "L IH0 NG Z"),
        # -locity joins the -ocity family (velocity) against the
        # open-syllable "lo" of local/locate below — thirty-fifth
        # probe band (band A)
        ("", "locity", " ", "L AA1 S AX T IY0"),
        ("", "locities", " ", "L AA1 S AX T IY0 Z"),
        ("", "lo", "c#", "L OW"),
        ("l", "l", "", ""),
        ("#^:", "l", "%", "AX L"),
        ("", "lead", "", "L IY D"),
        ("", "l", "", "L"),
    ],
    "m": [
        # -maker agent compounds carry a secondary (matchmaker,
        # lawmaker, shoemaker ... M EY2 K ER0); left ^ keeps bare
        # "maker" and vowel-linked stems on their own paths; the
        # double-m form (filmmaker) must outrank the mm digraph —
        # band R
        ("", "mmaker", "", "M EY2 K ER0"),
        ("^", "maker", "", "M EY2 K ER0"),
        # -man in compounds/derivatives reduces (fisherman, human,
        # woman, German); voiced-stem -sman voices the s (helmsman
        # HH EH1 L M Z M AH0 N, oarsman, salesman) — thirty-eighth
        # probe band (band E)
        ("#:^", "man", " ", "M AX N"),
        ("#", "man", " ", "M AX N"),
        # -marine keeps the French long I with final-element stress
        # (marine, submarine) — thirty-sixth probe band (band B)
        ("", "marine", " ", "M ER0 IY1 N"),
        ("", "marines", " ", "M ER0 IY1 N Z"),
        # -mony after an (unstressed) vowel keeps the American full O
        # with a secondary (ceremony, testimony, alimony, matrimony);
        # a consonant before -mony reduces it (harmony) — thirty-fifth
        # probe band (band A)
        ("#", "mony", " ", "M OW2 N IY0"),
        ("#", "monies", " ", "M OW2 N IY0 Z"),
        (" ", "mustache", "", "M AH1 S T AE2 SH"),
        (" ", "moustache", "", "M AH1 S T AE2 SH"),
        (" ", "micro", "", "M AY K R OW"),
        (" ", "mortgage", " ", "M AO1 R G AH0 JH"),
        (" ", "madrid", "", "M AH0 D R IH1 D"),
        (" ", "moscow", "", "M AA1 S K AW2"),
        (" ", "ms", " ", "M IH1 Z"),
        ("le", "man", " ", "M AX N"),
        ("le", "men", " ", "M IH N"),
        (" ", "monarch", " ", "M AA1 N AA0 R K"),
        (" ", "mexican", "", "M EH1 K S AH0 K AH0 N"),
        (" ", "mexico", "", "M EH1 K S AH0 K OW2"),
        (" ", "museum", "", "M Y UW0 Z IY1 AH0 M"),
        (" ", "machete", "", "M AH0 SH EH1 T IY0"),
        (" ", "mustache", "", "M AH1 S T AE2 SH"),
        (" ", "mr", " ", "M IH1 S T ER0"),
        (" ", "mrs", " ", "M IH1 S IH0 Z"),
        (" ", "miniature", "", "M IH1 N IY0 AX CH ER0"),
        (" ", "minute", " ", "M IH N AX T"),
        (" ", "minutes", " ", "M IH N AX T S"),
        # French loan ending (gourmet; helmet/comet keep M AX T)
        ("r", "met", " ", "M EY"),
        ("", "mb", "ing", "M"),
        ("", "mb", " ", "M"),
        ("", "mb", "s", "M"),
        # silent-mb stems keep the silent b in agent/past derivatives
        # (plumber, bomber, bombed); number/member/bombard keep B —
        # twenty-fourth probe band
        ("plu", "mb", "", "M"),
        ("bo", "mb", "e", "M"),
        (" ", "monitor", "", "M AA1 N AH0 T ER0"),
        # vehicles band (twenty-fifth probe)
        (" ", "motorcycle", "", "M OW1 T ER0 S AY2 K AH0 L"),
        (" ", "motor", "", "M OW1 T ER0"),
        (" ", "mileage", " ", "M AY1 L AH0 JH"),
        ("", "mn", " ", "M"),
        ("", "mn", "s", "M"),
        ("", "mov", "", "M UW V"),
        ("", "mm", "", "M"),
        ("", "m", "", "M"),
    ],
    "n": [
        # silent h in the -ngham place/fabric family (gingham,
        # Birmingham, Nottingham, Buckingham) — band M
        ("", "ngham", "", "NG AX M"),
        # -ngless compounds keep the soft NG (meaningless, wingless
        # ... NG L AH0 S) against the hard-g "ngle" path — band X
        ("", "ngless", " ", "NG L AX S"),
        # -ntain reduces after the ou of mountain/fountain (verbs like
        # maintain/contain never carry that left context); integral
        # front-stresses — round-5 CV sweep
        ("ou", "ntain", " ", "N T AX N"),
        ("ou", "ntains", " ", "N T AX N Z"),
        ("lo", "ngitude", " ", "N JH AX T UW2 D"),
        # -neath keeps the long E (beneath B IH0 N IY1 TH, underneath)
        ("", "neath", " ", "N IY1 TH"),
        # word-final -nge is the soft N JH (hinge, plunge, orange,
        # challenge, fringe); mid-word nge (angel, anger) unaffected —
        # fortieth probe band (band H)
        ("", "nge", " ", "N JH"),
        ("", "nged", " ", "N JH D"),
        ("", "nges", " ", "N JH IH0 Z"),
        # nitr- keeps the long I (nitrogen, nitrate, nitric) —
        # thirty-sixth probe band (band B)
        (" ", "nitr", "", "N AY T R"),
        (" ", "negotiat", "", "N IH0 G OW1 SH IY0 EY2 T"),
        (" ", "novel", "", "N AA1 V AH0 L"),
        (" ", "nevertheless", "", "N EH2 V ER0 DH AH0 L EH1 S"),
        (" ", "nonetheless", "", "N AH2 N DH AH0 L EH1 S"),
        (" ", "nearly", "", "N IH1 R L IY0"),
        (" ", "nobody", "", "N OW1 B AA2 D IY0"),
        (" ", "nowhere", "", "N OW1 W EH2 R"),
        (" ", "november", "", "N OW0 V EH1 M B ER0"),
        ("r", "nm", "", "M"),
        (" ", "nine", "", "N AY N"),
        ("", "ness", " ", "N AX S"),
        ("e", "ng", "+", "N JH"),
        ("", "ng", "r", "NG G"),
        ("", "ng", "#", "NG G"),
        ("", "ngl", "%", "NG G AX L"),
        ("", "ng", "", "NG"),
        ("", "nk", "", "NG K"),
        (" ", "now", " ", "N AW"),
        ("", "nn", "", "N"),
        ("", "n", "", "N"),
    ],
    "o": [
        # zoology family: both o letters sound (Z OW0 AA1 L AH0 JH) —
        # band P
        ("z", "oolog", "", "OW0 AA1 L AX JH"),
        # -ocracy government nouns stress the linking O (democracy,
        # theocracy, bureaucracy ... AA1 K R AH0 S IY0) — band Q
        ("", "ocracies", " ", "AA1 K R AX S IY0 Z"),
        ("", "ocracy", " ", "AA1 K R AX S IY0"),
        # high-frequency irregulars: only keeps the long O against the
        # closed-syllable default; word-initial offer- and the bare
        # noun log read AO — round-5 final CV sweep
        (" ", "only", " ", "OW1 N L IY0"),
        (" ", "offer", "", "AO1 F ER0"),
        (" l", "og", " ", "AO1 G"),
        (" l", "ogs", " ", "AO1 G Z"),
        # -ocious adjectives stress the long O (atrocious, ferocious,
        # precocious ... OW1 SH AH0 S) — band S
        ("", "ocious", "", "OW1 SH AX S"),
        # noteworthy: the silent-e stem keeps its long O — band R
        ("", "oteworthy", " ", "OW1 T W ER2 DH IY0"),
        # sociology keeps the soft c + linking IY0 (the bare ci->SH
        # digraph would swallow the i) — band P
        ("s", "ociolog", "", "OW2 S IY0 AA1 L AX JH"),
        # -onance/-onant Latinate nominals reduce both suffix vowels
        # (resonance R EH1 Z AH0 N AH0 N S, consonant, dissonant);
        # opponent/proponent spell -onent and are untouched — band O
        ("", "onances", " ", "AX N AX N S IH0 Z"),
        ("", "onance", " ", "AX N AX N S"),
        ("", "onant", "", "AX N AX N T"),
        # "oar" is the AO R rime everywhere (oar, board, roar, soar,
        # hoarse, coarse, oarsman) — thirty-eighth probe band (band E)
        ("", "oar", "", "AO R"),
        # "olt" keeps the long O (bolt, colt, volt, jolt, revolt) —
        # forty-first probe band (band I)
        ("", "olt", "", "OW L T"),
        ("", "olts", "", "OW L T S"),
        # m/p + oor is the UH R rime (moor, poor, spoor); door/floor
        # keep AO R — fortieth probe band (band H)
        ("m", "oor", "", "UH R"),
        ("p", "oor", "", "UH R"),
        # chemical -ogen nominals (hydrogen, nitrogen, estrogen,
        # pathogen) — thirty-sixth probe band (band B)
        ("", "ogen", " ", "AH0 JH AX N"),
        ("", "ogens", " ", "AH0 JH AX N Z"),
        # -olar keeps the long O (solar, polar, molar); scholar's
        # ch-context keeps AA — thirty-sixth probe band
        ("ch", "olar", "", "AA1 L ER0"),
        ("", "olar", " ", "OW1 L ER0"),
        ("", "olars", " ", "OW1 L ER0 Z"),
        # Greek -ometer instruments stress the joint O (barometer,
        # thermometer, kilometer, speedometer) — thirty-sixth probe
        # band
        ("", "ometer", " ", "AA1 M AX T ER0"),
        ("", "ometers", " ", "AA1 M AX T ER0 Z"),
        # Latinate suffix families that pin a non-initial primary; the
        # stress pass still reduces the pretonic vowels around the pin
        # (g2p.py round-5 always-reduce). -osity/-ocity keep the
        # voiceless S (generosity, velocity); -osure/-osal keep the
        # long O of the stem (exposure, closure, proposal, disposal);
        # -oval after a stem consonant is the -ove stem's UW (approval,
        # removal) while bare "oval" keeps its O via the left context —
        # thirty-fifth probe band (band A)
        ("", "osity", " ", "AA1 S AX T IY0"),
        ("", "osities", " ", "AA1 S AX T IY0 Z"),
        # onset-consonant + -ond monosyllables keep the open AA (pond,
        # bond, fond, blond); polysyllables (second, diamond) never
        # match the word-initial contexts — round-5 CV sweep
        (" ^", "ond", " ", "AA1 N D"),
        (" ^^", "ond", " ", "AA1 N D"),
        ("", "onze", " ", "AA1 N Z"),
        # chemical -ose sugars keep the voiceless S (glucose, sucrose);
        # verb close/chose keep Z via their l/h contexts
        ("c", "ose", " ", "OW0 S"),
        # frost family is the AO of lost/cost, not the OW of most
        ("fr", "o", "st", "AO"),
        # -ourish verbs are the ER of courage's family (nourish
        # N ER1 IH0 SH, flourish, nourishment)
        ("", "ourish", "", "ER1 IH0 SH"),
        # wool is the lone UH among the UW -ool words (and its
        # derivatives woolen/woolly) — forty-fourth probe band (band L)
        (" w", "ool", "", "UH1 L"),
        # control-family verbs reduce the con- prefix and stress the
        # final O (control K AH0 N T R OW1 L, controlling,
        # uncontrollable) — band L
        ("c", "ontrol", "", "AH0 N T R OW1 L"),
        # -orama spectacle nouns stress the suffix with a secondary on
        # the head (panorama P AE2 N ER0 AE1 M AH0, diorama) — band L
        ("", "orama", " ", "ER0 AE1 M AH0"),
        ("", "oramas", " ", "ER0 AE1 M AH0 Z"),
        # Latin -onus/-ocus keep the long O (bonus B OW1 N AH0 S, onus,
        # focus, locus, crocus)
        ("", "onus", " ", "OW1 N AX S"),
        ("", "ocus", "", "OW1 K AX S"),
        # forecast's silent e (the fore- prefix machinery blocks the
        # "cast" root so the whole word reaches the rules)
        ("f", "orecast", "", "AO1 R K AE2 S T"),
        (" ", "omelet", "", "AA1 M L AH0 T"),
        ("n", "omaly", "", "AA1 M AX L IY0"),
        ("", "omentum", "", "OW0 M EH1 N T AX M"),
        ("", "osium", " ", "OW1 Z IY0 AX M"),
        ("", "ouflage", "", "AH0 F L AA2 ZH"),
        (" ", "oregano", "", "ER0 EH1 G AH0 N OW2"),
        ("m", "olasses", "", "AH0 L AE1 S IH0 Z"),
        ("", "orridor", "", "AO1 R AX D AO2 R"),
        (" ", "octop", "", "AA1 K T AX P"),
        ("", "onquer", "", "AA1 NG K ER0"),
        ("", "ocity", " ", "AA1 S AX T IY0"),
        ("", "ocities", " ", "AA1 S AX T IY0 Z"),
        ("", "osure", " ", "OW1 ZH ER"),
        ("", "osures", " ", "OW1 ZH ER Z"),
        ("", "osal", " ", "OW1 Z AX L"),
        ("", "osals", " ", "OW1 Z AX L Z"),
        ("#:^", "oval", " ", "UW1 V AX L"),
        ("#:^", "ovals", " ", "UW1 V AX L Z"),
        # Greek -thesis/-osis nominals: stress the syllable before
        # -thesis (hypothesis), -osis keeps its own long O (diagnosis,
        # osmosis) — twenty-sixth probe band
        # sponge takes the strut vowel and a soft g —
        # thirtieth probe band
        ("p", "onge", " ", "AH1 N JH"),
        ("", "othesis", " ", "AA1 TH AH0 S AH0 S"),
        ("", "osis", " ", "OW1 S AH0 S"),
        (" ", "oasis", " ", "OW0 EY1 S AH0 S"),
        ("s", "occer", "", "AA1 K ER0"),
        ("c", "ompos", "e", "AH0 M P OW1 Z"),
        (" ", "obvious", "", "AA1 B V IY0 AH0 S"),
        (" ", "ordinar", "", "AO1 R D AH0 N EH2 R"),
        (" ", "office", "", "AO1 F AH0 S"),
        (" ", "orchestra", "", "AO1 R K AH0 S T R AH0"),
        (" ", "orchid", "", "AO1 R K AX D"),
        ("gh", "oul", "", "UW L"),
        ("g", "our", "met", "UH R"),
        ("p", "our", " ", "AO R"),
        ("p", "our", "s ", "AO R"),
        ("p", "our", "ing", "AO R"),
        ("p", "our", "ed", "AO R"),
        ("r", "o", "gue ", "OW"),
        ("v", "o", "gue ", "OW"),
        (" ", "oblique", "", "OW0 B L IY1 K"),
        (" ", "opinion", "", "AH0 P IH1 N Y AX N"),
        ("c", "olor", "", "AH L ER"),
        ("c", "olour", "", "AH L ER"),
        ("is", "oner", "", "AX N ER"),
        ("c", "oward", "", "AW ER D"),
        ("b", "oard", "", "AO R D"),
        ("br", "ochure", "", "OW0 SH UH1 R"),
        ("cr", "o", "che", "OW"),
        ("p", "orr", "idge", "AO R"),
        ("c", "ompeti", "tion", "AA M P AX T IH"),
        ("ph", "o", "tograph ", "OW"),
        ("ph", "o", "tographs ", "OW"),
        ("c", "ommunica", "", "AX M Y UW N AX K EY"),
        (" pr", "omise", "", "AA1 M AX S"),
        ("c", "omputer", "", "AX M P Y UW1 T ER0"),
        ("t", "omorrow", "", "AX M AA1 R OW2"),
        ("p", "ort", " ", "AO R T"),
        ("p", "ort", "s ", "AO R T S"),
        ("p", "ort", "ed", "AO R T"),
        ("p", "ort", "ing", "AO R T"),
        ("p", "ort", "er", "AO R T"),
        (" ", "october", "", "AA0 K T OW1 B ER0"),
        (" ", "oh", " ", "OW"),
        ("h", "orr", "", "AO R"),
        (" pr", "otect", "", "AH0 T EH1 K T"),
        (" ", "ocean", "", "OW SH AX N"),
        (" ", "onion", "", "AH N Y AX N"),
        (" ", "other", "", "AH DH ER"),
        ("m", "other", "", "AH DH ER"),
        ("br", "other", "", "AH DH ER"),
        (" n", "othing", "", "AH TH IH NG"),
        ("m", "onth", "", "AH N TH"),
        # compound pronouns keep the W of "one" and a full secondary
        ("every", "one", "", "W AH2 N"),
        ("some", "one", "", "W AH2 N"),
        ("any", "one", "", "W AH2 N"),
        ("m", "obile", " ", "OW1 B AH0 L"),
        ("", "otographer", "", "AH0 T AA1 G R AH0 F ER0"),
        # w+or = W ER (word, work) except -orn (worn, sworn)
        ("w", "orn", " ", "AO R N"),
        # strong-verb past -ove keeps OW after dr/gr/str (drove, grove)
        ("dr", "ove", " ", "OW V"),
        ("gr", "ove", " ", "OW V"),
        # the -ough lexical families
        ("d", "ough", "", "OW"),
        ("c", "offee", "", "AA1 F IY0"),
        ("c", "ough", "", "AO F"),
        ("tr", "ough", "", "AO F"),
        ("b", "ough", " ", "AW"),
        ("pl", "ough", "", "AW"),
        ("dr", "ought", "", "AW T"),
        ("", "oulder", "", "OW L D ER"),
        ("s", "oul", " ", "OW L"),
        ("s", "oul", "s ", "OW L"),
        ("l", "ood", "", "AH D"),
        ("p", "oor", "", "UH R"),
        ("m", "oor", " ", "UH R"),
        (" d", "one", " ", "AH N"),
        (" n", "one", " ", "AH N"),
        (" sh", "oe", "", "UW"),
        ("n", "oe", " ", "UW"),
        ("n", "oes", " ", "UW Z"),
        ("pr", "ove", " ", "UW V"),
        ("pr", "ove", "d", "UW V"),
        ("pr", "ove", "n", "UW V"),
        ("pr", "ove", "s ", "UW V"),
        ("m", "ove", "", "UW V"),
        ("t", "oward", "", "AX W AO R D"),
        ("", "olk", "", "OW K"),
        ("f", "oreign", "", "AO R AX N"),
        (" pr", "ogram", "", "OW1 G R AE2 M"),
        ("s", "oldier", "", "OW L JH ER"),
        ("p", "olice", "", "AX L IY S"),
        (" c", "onsider", "", "AX N S IH1 D ER0"),
        ("c", "ountr", "", "AH N T R"),
        ("", "oub", "l", "AH B"),
        (" c", "ousin", "", "AH Z AX N"),
        (" m", "oney", "", "AH N IY"),
        (" h", "oney", "", "AH N IY"),
        ("d", "ozen", "", "AH Z AX N"),
        (" l", "ose", " ", "UW Z"),
        (" l", "oser", "", "UW Z ER"),
        (" l", "osing", "", "UW Z IH NG"),
        # silent-b words: tomb/womb take UW, comb takes OW
        (" t", "omb", " ", "UW M"),
        (" t", "omb", "s ", "UW M"),
        (" w", "omb", " ", "UW M"),
        (" c", "omb", " ", "OW M"),
        (" c", "omb", "s ", "OW M"),
        (" c", "omb", "ing", "OW M"),
        (" c", "omb", "ed", "OW M"),
        ("#:", "our", " ", "ER"),
        ("#:", "our", "s ", "ER Z"),
        ("y", "our", "", "AO R"),
        ("f", "our", "", "AO R"),
        ("j", "our", "n", "ER"),
        ("c", "our", "age", "ER"),
        ("", "our", " ", "AW ER"),
        ("", "our", "s ", "AW ER Z"),
        ("t", "ou", "ch", "AH"),
        ("g", "one", " ", "AO N"),
        ("l", "ost", " ", "AO S T"),
        ("c", "ost", " ", "AO S T"),
        ("c", "ost", "s ", "AO S T S"),
        (" w", "omen", "", "IH M AX N"),
        (" w", "oman", "", "UH M AX N"),
        ("fr", "o", "m ", "AH"),
        ("n", "ow", "l", "AA"),
        ("", "oubt", "", "AW T"),
        ("", "ogne", " ", "OW N"),
        ("", "owel", "", "AW AX L"),
        ("", "of", " ", "AX V"),
        ("", "orough", "", "ER OW"),
        ("#:", "or", " ", "ER"),
        ("#:", "ors", " ", "ER Z"),
        ("", "orr", "", "AA R"),
        ("", "or", "", "AO R"),
        (" ", "one", "", "W AH N"),
        ("", "ongue", "", "AH NG"),
        ("#:^", "ogue", " ", "AO G"),
        (" ", "own", "", "OW N"),
        ("kn", "own", "", "OW N"),
        ("sh", "own", "", "OW N"),
        ("gr", "own", "", "OW N"),
        ("thr", "own", "", "OW N"),
        ("bl", "own", "", "OW N"),
        ("fl", "own", "", "OW N"),
        ("", "own", "", "AW N"),
        (" l", "ower", "", "OW ER"),
        (" sl", "ower", "", "OW ER"),
        ("", "ower", "", "AW ER"),
        (" all", "ow", "", "AW"),
        (" pl", "ow", "", "AW"),
        (" br", "ow", "", "AW"),
        ("", "owd", "", "AW D"),
        ("b", "owl", "", "OW L"),
        ("", "owl", "", "AW L"),
        ("", "ow", "", "OW"),
        (" ", "over", "", "OW V ER"),
        ("", "ov", "", "AH V"),
        ("", "o", "^%", "OW"),
        ("", "o", "^en", "OW"),
        ("", "o", "^i#", "OW"),
        ("", "ol", "d", "OW L"),
        ("", "ought", "", "AO T"),
        ("", "ough", "", "AH F"),
        (" ", "ou", "", "AW"),
        ("h", "ou", "s#", "AW"),
        # -ouse words must beat the -ous suffix rule (famous) below;
        # the r- family voices the s (rouse, arouse, carouse)
        ("r", "ouse", " ", "AW Z"),
        ("", "ouse", " ", "AW S"),
        ("", "ous", "", "AX S"),
        ("", "our", "", "AO R"),
        ("", "ould", "", "UH D"),
        ("^", "ou", "^l", "AH"),
        ("", "oup", "", "UW P"),
        ("", "ou", "", "AW"),
        ("", "oy", "", "OY"),
        ("", "oing", "", "OW IH NG"),
        ("", "oi", "", "OY"),
        ("", "oor", "", "AO R"),
        ("", "ook", "", "UH K"),
        ("", "ood", "", "UH D"),
        # consume -ooch before the epoch/stomach "o ch -> K" rule can
        # see a single-o left context (pooch, smooch)
        ("", "ooch", "", "UW CH"),
        ("", "oo", "", "UW"),
        ("", "o", "e", "OW"),
        ("", "o", " ", "OW"),
        ("", "oa", "", "OW"),
        (" ", "only", "", "OW N L IY"),
        (" ", "once", "", "W AH N S"),
        ("", "on't", "", "OW N T"),
        ("c", "o", "mp", "AH"),
        ("c", "o", "mf", "AH"),
        ("t", "o", "ma", "AH"),
        ("c", "o", "n", "AA"),
        ("", "o", "ng", "AO"),
        (" ^:", "o", "n", "AH"),
        ("i", "on", "", "AX N"),
        ("#:", "on", " ", "AX N"),
        ("#^", "on", "", "AX N"),
        ("", "o", "st ", "OW"),
        ("", "of", "^", "AO F"),
        ("", "other", "", "AH DH ER"),
        ("", "oss", " ", "AO S"),
        ("#^:", "om", "", "AH M"),
        ("", "o", "", "AA"),
    ],
    "p": [
        # -ptcy: the t is silent (bankruptcy B AE1 NG K R AH0 P S IY0)
        # — thirty-sixth probe band (band B)
        ("", "ptcy", " ", "P S IY0"),
        # Greek -phoria (euphoria Y UW0 F AO1 R IY0 AH0)
        ("", "phoria", " ", "F AO1 R IY0 AH0"),
        (" ", "pajamas", "", "P AH0 JH AA1 M AH0 Z"),
        (" ", "pajama", "", "P AH0 JH AA1 M AH0"),
        # noun-default protest keeps the long O with full second
        # syllable — thirty-first probe band
        (" ", "protest", "", "P R OW1 T EH2 S T"),
        # -page compound second element keeps the long vowel
        # (homepage, webpage, rampage) — twenty-sixth probe band
        ("#:", "page", " ", "P EY2 JH"),
        (" ", "parenthesis", " ", "P ER0 EH1 N TH AH0 S AH0 S"),
        (" ", "parentheses", " ", "P ER0 EH1 N TH AH0 S IY2 Z"),
        (" ", "piano", "", "P IY0 AE1 N OW0"),
        (" ", "palette", "", "P AE1 L AH0 T"),
        (" ", "particular", "", "P ER0 T IH1 K Y AH0 L ER0"),
        (" ", "pronunciation", "",
         "P R OW0 N AH2 N S IY0 EY1 SH AH0 N"),
        (" ", "pronounc", "", "P R AH0 N AW1 N S"),
        (" ", "polite", "", "P AH0 L AY1 T"),
        (" ", "police", "", "P AH0 L IY1 S"),
        (" ", "pedestrian", "", "P AH0 D EH1 S T R IY0 AH0 N"),
        (" ", "posse", " ", "P AA1 S IY0"),
        (" ", "percent", "", "P ER0 S EH1 N T"),
        (" ", "president", "", "P R EH1 Z AH0 D AH0 N T"),
        (" ", "politics", "", "P AA1 L AH0 T IH2 K S"),
        (" ", "professor", "", "P R AH0 F EH1 S ER0"),
        (" ", "parliament", "", "P AA1 R L AH0 M AH0 N T"),
        (" ", "profile", "", "P R OW1 F AY2 L"),
        (" ", "privileg", "", "P R IH1 V L AH0 JH"),
        (" ", "prisoner", "", "P R IH1 Z AX N ER0"),
        (" ", "potatoes", " ", "P AH0 T EY1 T OW2 Z"),
        (" ", "potato", "", "P AH0 T EY1 T OW2"),
        # verbal -plant compounds keep final stress (implant, supplant)
        ("#:^", "plant", "", "P L AE1 N T"),
        (" ", "pneumonia", "", "N UW0 M OW1 N Y AH0"),
        (" ", "psych", "", "S AY K"),
        (" ", "prepar", "e", "P R IY0 P EH1 R"),
        (" ", "pretend", "", "P R IY0 T EH1 N D"),
        (" ", "pursuit", "", "P ER0 S UW1 T"),
        (" ", "pursu", "", "P ER0 S UW1"),
        (" ", "ps", "", "S"),
        (" ", "pn", "", "N"),
        ("", "phe", " ", "F IY"),
        ("", "phes", " ", "F IY Z"),
        ("", "ph", "", "F"),
        ("", "peop", "", "P IY P"),
        ("", "pow", "", "P AW"),
        ("", "put", " ", "P UH T"),
        ("", "pp", "", "P"),
        ("", "p", "", "P"),
    ],
    "q": [
        # -quarium keeps the front EH (aquarium AH0 K W EH1 R IY0 AH0 M)
        ("", "quarium", "", "K W EH1 R IY0 AX M"),
        (" ", "queue", " ", "K Y UW1"),
        (" ", "quiche", "", "K IY1 SH"),
        # French loan ending (bouquet; banquet keeps K W AX T)
        ("ou", "quet", " ", "K EY"),
        ("", "que", " ", "K"),
        ("", "ques", " ", "K S"),
        # -quer finals drop the glide (lacquer L AE1 K ER0, conquer)
        ("", "quer", " ", "K ER"),
        ("", "quers", " ", "K ER Z"),
        ("", "quered", " ", "K ER D"),
        ("", "quar", "", "K W AO R"),
        ("", "qu", "", "K W"),
        ("", "q", "", "K"),
    ],
    "r": [
        # firefly: fire+fly keeps the compound diphthong; briefly has
        # no contiguous "refly" so adverbs are untouched — band N
        ("", "refly", " ", "R F L AY2"),
        # -rity abstract nouns reduce the suffix i (austerity,
        # celebrity, clarity, integrity ... R AH0 T IY0) — band O
        ("", "rities", " ", "R AX T IY Z"),
        ("", "rity", " ", "R AX T IY"),
        # resonan-/resonat- keep the full initial E against the re-
        # prefix rule (resonance R EH1 Z AH0 N AH0 N S, resonant,
        # resonate) — band O
        ("", "resonan", "", "R EH Z AX N AX N"),
        ("", "resonat", "", "R EH Z AX N EY2 T"),
        ("c", "riterion", "", "R AY0 T IH1 R IY0 AX N"),
        ("c", "riteria", "", "R AY0 T IH1 R IY0 AH0"),
        # -ranean Latinates (subterranean, mediterranean)
        ("", "ranean", " ", "R EY1 N IY0 AX N"),
        (" ", "refugee", "", "R EH2 F Y UW0 JH IY1"),
        (" ", "recommend", "", "R EH2 K AH0 M EH1 N D"),
        (" ", "responsibilit", "", "R IH0 S P AA2 N S AH0 B IH1 L AH0 T"),
        (" ", "responsib", "le", "R IH0 S P AA1 N S AH0 B"),
        # reg- splits: open-syllable region keeps IY, the Latinate
        # regimen(t) takes EH — twenty-sixth probe band
        (" ", "region", "", "R IY1 JH AH0 N"),
        (" ", "regimen", "", "R EH1 JH AH0 M AH0 N"),
        (" ", "restaurant", "", "R EH1 S T ER0 AA2 N T"),
        # name-initial brian keeps AY against the -rian rule below
        (" b", "rian", " ", "R AY1 AH0 N"),
        # Latinate -rian is an unstressed IY-glide syllable (pedestrian,
        # librarian, vegetarian, adrian) — twenty-fifth probe band
        ("", "rian", " ", "R IY0 AX N"),
        ("", "rians", " ", "R IY0 AX N Z"),
        (" ", "rhythm", "", "R IH1 DH AH0 M"),
        (" ", "rendezvous", " ", "R AA1 N D IH0 V UW2"),
        (" ", "recipe", " ", "R EH1 S AH0 P IY0"),
        (" ", "russia", "", "R AH1 SH AH0"),
        (" ", "receiv", "", "R AH0 S IY1 V"),
        (" ", "recogn", "", "R EH1 K AH0 G N"),
        (" ", "research", "", "R IY1 S ER0 CH"),
        # leave the t for the -tion/-tive rules (reaction needs ti->SH)
        (" ", "reac", "t", "R IY0 AE1 K"),
        (" ", "reinforce", "", "R IY2 IH0 N F AO1 R S"),
        ("b", "road", "", "R AO D"),
        (" ", "rh", "", "R"),
        (" ", "re", "^#", "R IH"),
        ("", "rr", "", "R"),
        ("", "r", "", "R"),
    ],
    "s": [
        # the anti- prefix boundary blocks intervocalic voicing
        # (antiseptic ... T AH0 S EH1 P..., antisocial) — round-5
        # final CV sweep
        ("anti", "s", "", "S"),
        # horsefly-style compounds: silent linking e before the -fly
        # element (horsefly HH AO1 R S F L AY2) — band N
        ("", "sefly", " ", "S F L AY2"),
        # double-s + ian palatalizes voiceless (russian R AH1 SH AH0 N,
        # hessian, prussian) before the i-bucket's voiced s+ian rule
        # (asian, persian) can see the second s as its left context —
        # forty-fourth probe band (band L)
        ("s", "sian", " ", "SH AX N"),
        ("s", "sians", " ", "SH AX N Z"),
        # ... single s + ian palatalizes voiced (asian EY1 ZH AH0 N,
        # persian, parisian, caucasian)
        ("", "sian", " ", "ZH AX N"),
        ("", "sians", " ", "ZH AX N Z"),
        # and the bare -sia hiatus does the same (asia EY1 ZH AH0,
        # amnesia, anesthesia, malaysia), voiceless after double s
        # (russia R AH1 SH AH0) — band L
        ("s", "sia", " ", "SH AH0"),
        ("", "sia", " ", "ZH AH0"),
        # unstressed final -sil reduces (fossil F AA1 S AH0 L, tonsil,
        # utensil) — band L
        ("", "sil", " ", "S AX L"),
        ("", "sils", " ", "S AX L Z"),
        # n + sure is the stressed SH UH R (insure, ensure, unsure) —
        # thirty-ninth probe band (band G)
        ("n", "sure", " ", "SH UH1 R"),
        ("n", "sured", " ", "SH UH1 R D"),
        ("n", "sures", " ", "SH UH1 R Z"),
        # voiced-stem -sman voices the s (helmsman, oarsman,
        # salesman, spokesman) — thirty-eighth probe band (band E)
        ("e", "sman", " ", "Z M AX N"),
        ("r", "sman", " ", "Z M AX N"),
        ("m", "sman", " ", "Z M AX N"),
        ("l", "sman", " ", "Z M AX N"),
        # -sphere compounds: secondary IH R (atmosphere, hemisphere,
        # stratosphere); spheric- keeps the short E (spherical) —
        # thirty-fifth probe band (band A)
        ("", "spheric", "", "S F EH R IH K"),
        ("", "sphere", " ", "S F IH2 R"),
        ("", "spheres", " ", "S F IH2 R Z"),
        # Latin suade: persuade P ER0 S W EY1 D, persuasion, suave is
        # lexicon — thirty-fifth probe band
        ("", "suade", "", "S W EY1 D"),
        ("", "suasion", " ", "S W EY1 ZH AX N"),
        ("", "suasive", "", "S W EY1 S IH0 V"),
        # Greek -sis stays voiceless with a reduced final (basis,
        # crisis, analysis, oasis) — twenty-sixth probe band
        ("#", "sis", " ", "S AH0 S"),
        # su+vowel glides to S W before d (persuade, dissuade);
        # suave is a lexicon pin — thirty-second probe band
        ("", "sua", "d", "S W EY"),
        (" ", "sacrific", "", "S AE1 K R AH0 F AY2 S"),
        # -psule reduces (capsule K AE1 P S AH0 L)
        ("p", "sule", " ", "S AX L"),
        # Greek -saur(us) keeps the voiceless S between vowels
        # (thesaurus TH AH0 S AO1 R AH0 S, dinosaur)
        ("", "saurus", " ", "S AO1 R AX S"),
        ("", "saur", " ", "S AO2 R"),
        ("", "saurs", " ", "S AO2 R Z"),
        ("", "scarce", "", "S K EH1 R S"),
        # -sley keeps the cluster (parsley P AA1 R S L IY0, paisley)
        ("", "sley", " ", "S L IY0"),
        ("", "stalgia", "", "S T AE1 L JH AH0"),
        # voiceless s in -stasy (ecstasy EH1 K S T AH0 S IY0)
        ("", "stasy", " ", "S T AX S IY0"),
        # Norwegian loan "ski" keeps the long I in all its forms; the
        # bare-grapheme rules below would read the magic-e pattern
        (" ", "ski", " ", "S K IY1"),
        (" ", "skis", " ", "S K IY1 Z"),
        (" ", "skiing", " ", "S K IY1 IH0 NG"),
        (" ", "skier", " ", "S K IY1 ER0"),
        (" ", "skiers", " ", "S K IY1 ER0 Z"),
        ("d", "scape", " ", "S K EY2 P"),
        (" ", "sufficient", "", "S AH0 F IH1 SH AH0 N T"),
        (" ", "sesame", "", "S EH1 S AH0 M IY0"),
        (" ", "simile", "", "S IH1 M AH0 L IY0"),
        (" ", "societ", "", "S AH0 S AY1 AH0 T"),
        (" ", "somebody", "", "S AH1 M B AA2 D IY0"),
        (" ", "somewhere", "", "S AH1 M W EH2 R"),
        ("ea", "s", " ", "Z"),
        # brow+se voices (browse, browser, browsing) —
        # twenty-ninth probe band
        ("w", "s", "e", "Z"),
        ("w", "s", "i", "Z"),
        ("b", "s", "erv", "Z"),
        # linking-s compounds voice before -man after a vowel
        # (salesman, statesman, spokesman); craftsman's t-s stays S —
        # twenty-fourth probe band
        (" ", "salesman", " ", "S EY1 L Z M AH0 N"),
        ("#", "sman", " ", "Z M AX N"),
        (" ", "sovereign", "", "S AA1 V R AX N"),
        (" u", "sage", " ", "S AX JH"),
        (" ", "sergeant", "", "S AA1 R JH AX N T"),
        (" ", "sew", "", "S OW"),
        (" ", "shepherd", "", "SH EH1 P ER0 D"),
        (" ", "september", "", "S EH0 P T EH1 M B ER0"),
        (" ", "shampoo", "", "SH AE0 M P UW1"),
        (" ", "surpris", "", "S ER0 P R AY1 Z"),
        (" ", "sure", "", "SH UH R"),
        (" ", "sugar", "", "SH UH G ER"),
        (" ", "shall", " ", "SH AE L"),
        ("", "stle", "", "S AX L"),
        ("", "scle", "", "S AX L"),
        ("rou", "se", " ", "Z"),
        ("ou", "se", " ", "S"),
        # final "-ase" is voiceless (case, base, chase, purchase);
        # ph(r)ase are the voiced exceptions, and "-ease" keeps the
        # voiced default (please, tease, ease, disease) with its own
        # S-exceptions pinned under c/l/g — twenty-third probe band
        ("pha", "se", " ", "Z"),
        ("phra", "se", " ", "Z"),
        ("ea", "se", " ", "Z"),
        ("a", "se", " ", "S"),
        (" ", "schedule", " ", "S K EH1 JH UW0 L"),
        ("", "sh", "", "SH"),
        ("", "stle", "", "S AX L"),
        ("", "sten", " ", "S AX N"),
        ("#", "sion", "", "ZH AX N"),
        ("", "some", "", "S AH M"),
        ("#", "sur", "#", "ZH ER"),
        ("", "sur", "#", "SH ER"),
        ("#", "su", "#", "ZH UW"),
        ("#", "ssu", "#", "SH UW"),
        ("#", "sed", " ", "Z D"),
        ("#", "s", "#", "Z"),
        ("", "said", "", "S EH D"),
        ("^", "sion", "", "SH AX N"),
        ("", "s", "s", ""),
        (".", "s", " ", "Z"),
        ("#:.e", "s", " ", "Z"),
        ("#^:##", "s", " ", "Z"),
        ("#^:#", "s", " ", "S"),
        ("u", "s", " ", "S"),
        (" :#", "s", " ", "Z"),
        (" ", "sch", "", "S K"),
        ("", "s", "c+", ""),
        ("#", "sm", "", "Z M"),
        ("#", "sn", "'", "Z AX N"),
        ("", "s", "", "S"),
    ],
    "t": [
        # t + -hood suffix stays a stop + aspirate, not a th digraph
        # (parenthood P EH1 R AH0 N T HH UH2 D) — band X
        ("", "thood", " ", "T HH UH2 D"),
        ("", "thoods", " ", "T HH UH2 D Z"),
        # -trol verbs stress the final O (patrol P AH0 T R OW1 L);
        # petrol keeps its initial stress via the e left context
        # falling through; control is the o-bucket "ontrol" rule —
        # forty-fourth probe band (band L)
        ("a", "trol", " ", "T R OW1 L"),
        ("a", "trols", " ", "T R OW1 L Z"),
        ("a", "trolled", " ", "T R OW1 L D"),
        ("a", "trolling", " ", "T R OW1 L IH0 NG"),
        # -tula palatalizes (spatula S P AE1 CH AH0 L AH0, tarantula)
        ("", "tula", " ", "CH AX L AH0"),
        # initial therm- is the voiceless Greek root (thermostat,
        # thermal, thermometer) against the voiced there/then family
        (" ", "therm", "", "TH ER M"),
        # -torium halls stress the suffix O (auditorium)
        ("", "torium", " ", "T AO1 R IY0 AX M"),
        ("", "tasy", " ", "T AX S IY0"),
        # tz devoices to T S (quartz, waltz, blitz) — thirty-ninth
        # probe band (band G)
        ("", "tz", "", "T S"),
        # French tour- keeps UH R word-finally and in touri- stems
        # (tour, detour, contour, tourist, tourism); tournament keeps
        # its established AO via the narrower contexts — thirty-fifth
        # probe band (band A)
        ("", "tour", " ", "T UH1 R"),
        ("", "tours", " ", "T UH1 R Z"),
        # leave the i for the -ism/-ist suffix rules
        ("", "tour", "i", "T UH1 R"),
        # -turity palatalizes like -ture (maturity
        # M AH0 CH UH1 R AH0 T IY0) — thirty-fifth probe band
        ("", "turity", " ", "CH UH1 R AX T IY0"),
        ("", "turities", " ", "CH UH1 R AX T IY0 Z"),
        (" ", "thesis", " ", "TH IY1 S IH0 S"),
        # Greek therap- keeps voiceless TH against the function-word
        # th-voicing default — twenty-seventh probe band
        (" ", "therap", "", "TH EH1 R AH0 P"),
        (" ", "total", " ", "T OW1 T AH0 L"),
        (" ", "trophy", "", "T R OW1 F IY0"),
        (" ", "therefore", "", "DH EH1 R F AO2 R"),
        (" ", "translation", "", "T R AE0 N S L EY1 SH AH0 N"),
        (" ", "translat", "e", "T R AE0 N S L EY1 T"),
        (" ", "tokyo", "", "T OW1 K IY0 OW2"),
        (" ", "trouser", "", "T R AW1 Z ER0"),
        (" ", "timid", "", "T IH1 M AH0 D"),
        # any-/every- second element -thing keeps a secondary
        ("y", "thing", " ", "TH IH2 NG"),
        ("", "tiful", "", "T AX F AX L"),
        (" ", "technolog", "", "T EH0 K N AA1 L AH0 JH"),
        (" ", "technique", "", "T EH0 K N IY1 K"),
        (" ", "temperature", "", "T EH1 M P R AX CH ER0"),
        (" ", "theatre", "", "TH IY1 AH0 T ER0"),
        (" ", "theat", "", "TH IY1 AH0 T"),
        # silent t in V+sten / V+ften (listen, fasten, soften, often);
        # consonant+sten keeps it (tungsten)
        ("#s", "t", "en", ""),
        ("#f", "t", "en", ""),
        ("is", "t", "m", ""),
        ("", "tch", "", "CH"),
        (" ", "the", " ", "DH AX"),
        ("", "to", " ", "T UW"),
        ("", "that", " ", "DH AE T"),
        (" ", "this", " ", "DH IH S"),
        (" ", "they", "", "DH EY"),
        (" ", "there", "", "DH EH R"),
        ("", "ther", "", "DH ER"),
        ("", "their", "", "DH EH R"),
        (" ", "than", " ", "DH AE N"),
        (" ", "them", " ", "DH EH M"),
        ("", "these", " ", "DH IY Z"),
        (" ", "then", "", "DH EH N"),
        ("", "through", "", "TH R UW"),
        ("", "those", "", "DH OW Z"),
        ("", "though", " ", "DH OW"),
        (" ", "thus", "", "DH AH S"),
        ("", "th", "", "TH"),
        ("#:", "ted", " ", "T IH D"),
        ("s", "ti", "#n", "CH"),
        ("", "ti", "o", "SH"),
        ("", "ti", "a", "SH"),
        ("", "tien", "", "SH AX N"),
        ("", "tur", "#", "CH ER"),
        ("", "tu", "a", "CH UW"),
        (" ", "two", "", "T UW"),
        ("", "tt", "", "T"),
        ("", "t", "", "T"),
    ],
    "u": [
        # upholster family: silent-ish ph boundary reads P, stressed
        # long o (upholstery AH0 P OW1 L S T ER0 IY0) — band M
        (" ", "upholst", "", "AH0 P OW1 L S T"),
        # fluorescent/fluorescence read UH0 R before the stressed
        # suffix — band P
        ("l", "uorescen", "", "UH0 R EH1 S AX N"),
        # -ular adjectives palatalize the u and reduce (circular
        # S ER1 K Y AH0 L ER0, molecular, muscular); stress lands on
        # the preceding syllable via the _PENULT_STRESS entry —
        # thirty-ninth probe band (band G)
        # (bare ER so the stress pass counts the suffix vowels when
        # placing the antepenult primary)
        ("", "ularly", " ", "Y AX L ER L IY0"),
        ("", "ular", " ", "Y AX L ER"),
        # p/b/f + ull is the UH rime (pull, bull, full, bullet,
        # pulley); dull/gull/hull keep AH — forty-first probe band
        ("p", "ull", "", "UH L"),
        ("b", "ull", "", "UH L"),
        ("f", "ull", "", "UH L"),
        # urr before a vowel is the plain ER rime (current, currency,
        # hurry, burrow, furry) — the doubled r never syllabifies as a
        # separate phone — thirty-sixth probe band (band B)
        ("", "urr", "#", "ER"),
        # -ure after a vowel+l stem is the L-Y-ER rime (failure);
        # double-l (allure) and bare lure keep UH R via the context —
        # thirty-fifth probe band (band A)
        ("#l", "ure", " ", "Y ER"),
        ("#l", "ures", " ", "Y ER Z"),
        (" ", "utensil", "", "Y UW0 T EH1 N S AH0 L"),
        # up+date compound keeps the full second element against the
        # -ate reduction (climate/senate) — twenty-ninth probe band
        (" ", "updat", "", "AH1 P D EY2 T"),
        # cushion keeps the UH lax vowel — thirtieth probe band
        ("c", "ushion", "", "UH1 SH AH0 N"),
        # -ulation reduces the glide syllable after a velar/labial
        # (population, regulation, calculation) —
        # thirty-first probe band
        ("p", "ul", "ati", "Y AH0 L"),
        ("g", "ul", "ati", "Y AH0 L"),
        ("c", "ul", "ati", "Y AH0 L"),
        # -ulance/-ulant reduce the u-glide syllable (ambulance,
        # petulant) — twenty-seventh probe band
        ("", "ulance", " ", "Y AH0 L AH0 N S"),
        ("", "ulances", " ", "Y AH0 L AH0 N S IH0 Z"),
        (" ", "useless", "", "Y UW1 S L AH0 S"),
        # "-urance" nouns keep the tense UH1 of the -ure verb
        # (insurance, assurance, endurance) — twenty-third probe band
        ("", "urance", " ", "UH1 R AH0 N S"),
        (" ", "unless", "", "AH0 N L EH1 S"),
        (" ", "until", "", "AH0 N T IH1 L"),
        (" ", "unfortunate", "", "AH0 N F AO1 R CH AH0 N AH0 T"),
        # -uity abstract nouns stress the U; y-glide drops after the
        # @-set coronals (annuity AH0 N UW1 AH0 T IY0, gratuity) and
        # survives elsewhere (acuity, ambiguity) — round-5 CV sweep
        ("@", "uity", " ", "UW1 AX T IY0"),
        ("", "uity", " ", "Y UW1 AX T IY0"),
        # -ulent adjectives glide and reduce (turbulent
        # T ER1 B Y AH0 L AH0 N T, opulent, succulent)
        ("", "ulent", " ", "Y AX L AX N T"),
        # punish is the lone short-u -unish (P AH1 N IH0 SH)
        ("p", "unish", "", "AH1 N IH0 SH"),
        # -ulation nominals glide except after s (calculation vs
        # insulation IH2 N S AH0 L EY1 SH AH0 N)
        ("s", "ulation", "", "AX L EY1 SH AX N"),
        ("", "ulation", "", "Y AX L EY1 SH AX N"),
        ("z", "ucchini", "", "UW0 K IY1 N IY0"),
        ("t", "uxedo", "", "AH0 K S IY1 D OW0"),
        ("c", "ulin", "ar", "AH1 L AX N"),
        # final -ula nominals glide and reduce (formula
        # F AO1 R M Y AH0 L AH0, nebula); s-stems skip the glide
        # (peninsula via its insula rule); -ulator agents keep the
        # glide with the -ator secondary (calculator, regulator)
        ("s", "ula", " ", "AX L AH0"),
        ("", "ula", " ", "Y AX L AH0"),
        ("", "ulator", " ", "Y AX L EY2 T ER0"),
        ("", "ulators", " ", "Y AX L EY2 T ER0 Z"),
        # incubator (the -ator family pins the EY2)
        ("", "ubator", " ", "Y AX B EY2 T ER0"),
        ("", "umvent", "", "AX M V EH1 N T"),
        ("", "umference", "", "AH1 M F ER0 AX N S"),
        (" ", "universe", "", "Y UW1 N AH0 V ER2 S"),
        (" ", "usual", "", "Y UW1 ZH AX W AX L"),
        (" ", "umbrella", "", "AH0 M B R EH1 L AH0"),
        ("n", "uisance", "", "UW1 S AX N S"),
        ("p", "urpose", "", "ER1 P AX S"),
        ("l", "uable", "", "Y AX B AX L"),
        (" ", "upon", "", "AX P AA N"),
        ("st", "ud", "y", "AH D"),
        ("st", "udie", "", "AH D IY"),
        # "ui" digraph after s/r/j/n is a bare UW (suit, fruit, juice,
        # nuisance, cruise); gu-/cu- spellings never reach these rules
        # with that left context (guide, biscuit)
        ("s", "ui", "^", "UW"),
        ("r", "ui", "^", "UW"),
        ("j", "ui", "^", "UW"),
        ("n", "ui", "^", "UW"),
        (" ", "use", " ", "Y UW S"),
        ("b", "usiness", "", "IH Z N AX S"),
        ("c", "uit", " ", "AX T"),
        ("g", "uise", "", "AY Z"),
        ("", "uise", "", "UW Z"),
        ("", "ubtle", "", "AH T AX L"),
        (" ", "un", "i", "Y UW N"),
        (" ", "un", "", "AH N"),
        (" ", "upon", "", "AX P AO N"),
        ("@", "ur", "#", "UH R"),
        ("", "ur", "#", "Y UH R"),
        ("", "ur", "", "ER"),
        ("", "u", "^ ", "AH"),
        ("", "u", "^^", "AH"),
        ("", "uy", "", "AY"),
        (" g", "u", "#", ""),
        ("g", "u", "%", ""),
        ("g", "u", "#", "W"),
        ("#n", "u", "", "Y UW"),
        ("@", "u", "", "UW"),
        ("", "u", "", "Y UW"),
    ],
    "v": [
        # French-final-stress -ine loan — twenty-seventh probe band
        (" ", "vaccine", "", "V AE0 K S IY1 N"),
        (" ", "vitamin", "", "V AY1 T AH0 M AH0 N"),
        (" ", "vacuum", "", "V AE1 K Y UW0 M"),
        (" ", "vital", " ", "V AY1 T AH0 L"),
        (" ", "violin", "", "V AY2 AH0 L IH1 N"),
        (" ", "valet", "", "V AE0 L EY1"),
        (" ", "vineyard", "", "V IH1 N Y ER0 D"),
        (" ", "vehicle", "", "V IY1 IH0 K AH0 L"),
        (" ", "victual", "", "V IH1 T AX L"),
        (" ", "viscount", "", "V AY1 K AW2 N T"),
        (" ", "vegetable", "", "V EH1 JH T AX B AX L"),
        ("", "view", "", "V Y UW"),
        ("", "v", "", "V"),
    ],
    "w": [
        # -ward suffix after the in- prefix and silent-e stems
        # (inward IH1 N W ER0 D, homeward); reward keeps its stressed
        # verb reading because only -meward matches a silent e — band Q
        (" in", "ward", " ", "W ER0 D"),
        (" in", "wards", " ", "W ER0 D Z"),
        ("me", "ward", " ", "W ER0 D"),
        ("me", "wards", " ", "W ER0 D Z"),
        # -worthy compound finals (noteworthy, praiseworthy,
        # trustworthy ... W ER2 DH IY0); the standalone adjective
        # keeps its primary — band R
        (" ", "worthy", " ", "W ER1 DH IY0"),
        ("", "worthy", " ", "W ER2 DH IY0"),
        (" ", "whilst", "", "W AY1 L S T"),
        (" ", "whereas", "", "W EH0 R AE1 Z"),
        (" ", "windy", "", "W IH1 N D IY0"),
        (" ", "wherever", "", "W EH0 R EH1 V ER0"),
        (" ", "whatever", "", "W AH2 T EH1 V ER0"),
        (" ", "whoever", "", "HH UW0 EH1 V ER0"),
        ("n", "while", " ", "W AY2 L"),
        # -washer compound second element (dishwasher) —
        # thirtieth probe band
        ("h", "washer", " ", "W AA2 SH ER0"),
        ("h", "washers", " ", "W AA2 SH ER0 Z"),
        # -work as a compound second element takes secondary stress
        # after any vowel(+consonants) first element (network,
        # homework, woodwork) — generalized from the t-only context in
        # the twenty-sixth probe band
        ("#:", "work", " ", "W ER2 K"),
        ("#:", "works", " ", "W ER2 K S"),
        ("t", "ware", " ", "W EH2 R"),
        ("d", "ware", " ", "W EH2 R"),
        (" ", "worthy", "", "W ER1 DH IY0"),
        (" ", "worship", "", "W ER1 SH AX P"),
        (" ", "what", " ", "W AH T"),
        (" ", "with", " ", "W IH DH"),
        (" ", "within", "", "W IH0 DH IH1 N"),
        (" ", "wa", "ter", "W AO"),
        # silent w only in the standalone sword (password keeps W) —
        # twenty-ninth probe band
        (" s", "w", "ord", ""),
        # wire+l drops the ER offglide (wireless); bare wire(s/d)
        # keeps it — twenty-ninth probe band
        (" ", "wire", "l", "W AY1 R"),
        (" ", "wire", " ", "W AY1 ER0"),
        (" ", "wires", " ", "W AY1 ER0 Z"),
        (" ", "wired", " ", "W AY1 ER0 D"),
        # -word compound second element takes secondary stress
        # (password, crossword, keyword); the silent-w sword rule
        # above wins for the standalone noun — twenty-ninth probe band
        ("#:", "word", " ", "W ER2 D"),
        ("#:", "words", " ", "W ER2 D Z"),
        (" ", "were", "", "W ER"),
        ("", "wa", "s", "W AA"),
        ("", "wa", "t", "W AA"),
        ("", "where", "", "W EH R"),
        ("", "what", "", "W AA T"),
        ("", "whol", "", "HH OW L"),
        ("", "who", "", "HH UW"),
        ("", "wh", "", "W"),
        ("", "war", "", "W AO R"),
        ("", "worn", " ", "W AO R N"),
        ("", "wor", "^", "W ER"),
        ("", "wr", "", "R"),
        ("", "w", "", "W"),
    ],
    "x": [
        (" ", "x", "", "Z"),
        ("", "x", "", "K S"),
    ],
    "y": [
        # Latin -yrus keeps the long Y (papyrus P AH0 P AY1 R AH0 S,
        # Cyrus) — round-5 CV sweep
        ("", "yrus", " ", "AY1 R AX S"),
        # oxygen joins the -ogen family through its y spelling —
        # thirty-ninth probe band (band G)
        ("", "ygen", " ", "AH0 JH AX N"),
        # Greek -yme/-yte keep the long Y (enzyme, electrolyte) —
        # thirty-seventh probe band (band C)
        ("", "yme", " ", "AY2 M"),
        ("", "ymes", " ", "AY2 M Z"),
        ("", "yte", " ", "AY2 T"),
        ("", "ytes", " ", "AY2 T S"),
        # Greek -ysis reduces both vowels (analysis, paralysis,
        # dialysis) — twenty-sixth probe band
        ("", "ysis", " ", "AH0 S AH0 S"),
        ("ph", "y", "s", "IH"),
        # open y before the -cle coda is AY (cycle, recycle, cyclone,
        # encyclopedia) — twenty-fifth probe band
        ("c", "y", "cl", "AY"),
        (" ", "yacht", "", "Y AA T"),
        ("", "young", "er", "Y AH NG G"),
        ("", "young", "est", "Y AH NG G"),
        ("", "young", "", "Y AH NG"),
        (" ", "your", "", "Y AO R"),
        (" ", "you", "", "Y UW"),
        (" ", "yes", "", "Y EH S"),
        (" ", "y", "", "Y"),
        ("#^:", "y", " ", "IY"),
        ("#^:", "y", "i", "IY"),
        (" :", "y", " ", "AY"),
        (" :", "y", "#", "AY"),
        (" :", "y", "^+:#", "IH"),
        (" :", "y", "^#", "AY"),
        ("", "y", "", "IH"),
    ],
    "z": [
        # z + -ure palatalizes (seizure S IY1 ZH ER0, azure) —
        # thirty-fifth probe band (band A)
        ("", "zure", " ", "ZH ER"),
        ("", "zures", " ", "ZH ER Z"),
        ("", "zz", "", "Z"),
        ("", "z", "", "Z"),
    ],
    "'": [
        ("#:.e", "'s", " ", "Z"),
        ("#", "'s", " ", "Z"),
        ("", "'", "", ""),
    ],
}
