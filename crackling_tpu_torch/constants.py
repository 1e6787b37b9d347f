"""Result codes, module names and the guide record schema.

Behavioral contract mirrors the reference implementation
(/root/reference/src/crackling/Constants.py:1-70): guides carry a 26-field
record; every field is emitted in ``GUIDE_COLUMNS`` order in the results CSV.
"""

CODE_ACCEPTED = 1
CODE_REJECTED = 0
CODE_UNTESTED = "?"
CODE_AMBIGUOUS = "-"
CODE_ERROR = "!"

MODULE_MM10DB = "mm10db"
MODULE_SGRNASCORER2 = "sgrnascorer2"
MODULE_CHOPCHOP = "chopchop"
MODULE_CONSENSUS = "consensus"
MODULE_SPECIFICITY = "specificity"

# The 26 per-guide properties and their default values
# (reference Constants.py:13-40).
DEFAULT_GUIDE_PROPERTIES = {
    "seq": "",
    "header": "",
    "isUnique": CODE_ACCEPTED,
    "start": CODE_UNTESTED,
    "end": CODE_UNTESTED,
    "strand": CODE_UNTESTED,
    "passedTTTT": CODE_UNTESTED,
    "passedATPercent": CODE_UNTESTED,
    "passedG20": CODE_UNTESTED,
    "passedSecondaryStructure": CODE_UNTESTED,
    "ssL1": CODE_UNTESTED,
    "ssStructure": CODE_UNTESTED,
    "ssEnergy": CODE_UNTESTED,
    "acceptedByMm10db": CODE_UNTESTED,
    "acceptedBySgRnaScorer": CODE_UNTESTED,
    "consensusCount": CODE_UNTESTED,
    "passedBowtie": CODE_UNTESTED,
    "passedOffTargetScore": CODE_UNTESTED,
    "sgrnascorer2score": CODE_UNTESTED,
    "AT": CODE_UNTESTED,
    "bowtieChr": CODE_UNTESTED,
    "bowtieStart": CODE_UNTESTED,
    "bowtieEnd": CODE_UNTESTED,
    "mitOfftargetscore": CODE_UNTESTED,
    "cfdOfftargetscore": CODE_UNTESTED,
    "passedAvoidLeadingT": CODE_UNTESTED,
}

# Output column order (reference Constants.py:42-70).
GUIDE_COLUMNS = [
    "seq",
    "sgrnascorer2score",
    "header",
    "start",
    "end",
    "strand",
    "isUnique",
    "passedG20",
    "passedTTTT",
    "passedATPercent",
    "passedSecondaryStructure",
    "ssL1",
    "ssStructure",
    "ssEnergy",
    "acceptedByMm10db",
    "acceptedBySgRnaScorer",
    "consensusCount",
    "passedBowtie",
    "passedOffTargetScore",
    "AT",
    "bowtieChr",
    "bowtieStart",
    "bowtieEnd",
    "mitOfftargetscore",
    "cfdOfftargetscore",
    "passedAvoidLeadingT",
]

# Kept for API compatibility with code written against the reference name.
DEFAULT_GUIDE_PROPERTIES_ORDER = GUIDE_COLUMNS

# The 80-nt tracrRNA scaffold appended to 'G' + spacer[1:20] for the
# secondary-structure gate (reference Crackling.py:395).
SCAFFOLD_RNA = (
    "GUUUUAGAGCUAGAAAUAGCAAGUUAAAAUAAGGCUAGUCCGUUAUCAACUUGAAAAAGUGGCACCGAGUCGGUGCUUUU"
)

# Regex applied to the RNAfold-style output line to detect the canonical
# scaffold fold (reference Crackling.py:396-397).
PATTERN_RNA_STRUCTURE = (
    r".{28}\({4}\.{4}\){4}\.{3}\){4}.{21}\({4}\.{4}\){4}\({7}\.{3}\){7}\.{3}\s\((.+)\)"
)
PATTERN_RNA_ENERGY = r"\s\((.+)\)"
