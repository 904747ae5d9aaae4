"""The five relQuery task types (paper Table 5) with per-dataset adaptations.

``render(template, row)`` substitutes ``{attr}`` placeholders with row values —
Definition 2.1's ζ[s_i].
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.data.tables import Table

# output-length limits per query type (paper §5.1)
OUTPUT_LIMITS = {
    "filter": 5,
    "classify": 10,
    "rating": 5,
    "summarize": 50,
    "open": 100,
}


@dataclass(frozen=True)
class RelQueryTemplate:
    template_id: str
    qtype: str                  # filter | classify | rating | summarize | open
    text: str                   # contains {attr} placeholders

    @property
    def max_output_tokens(self) -> int:
        return OUTPUT_LIMITS[self.qtype]

    @property
    def attributes(self) -> List[str]:
        return re.findall(r"\{(\w+)\}", self.text)

    def render(self, row: Dict[str, str]) -> str:
        out = self.text
        for attr in self.attributes:
            if attr not in row:
                # A silent empty substitution here poisons everything above:
                # dedup keys collide across genuinely different rows and the
                # planner's column projection can drop a column it believed
                # unused. Fail loudly instead.
                raise KeyError(
                    f"template {self.template_id!r}: row has no attribute "
                    f"{attr!r} (row columns: {sorted(row)})")
            out = out.replace("{" + attr + "}", row[attr])
        return out


def default_templates(dataset: str, item_attr: str, review_attr: str) -> List[RelQueryTemplate]:
    """Five templates per dataset ≈ the paper's 4 datasets x 5 types = 20."""
    mk = lambda qt, text: RelQueryTemplate(f"{dataset}/{qt}", qt, text)
    return [
        mk("filter", "Decide whether this item is suitable for children based on the "
                     f"description {{{item_attr}}} . Answer yes or no only ."),
        mk("classify", "Categorize the sentiment of the review "
                       f"{{{review_attr}}} as Negative , Positive , or Neutral ."),
        mk("rating", "Predict the user's rating from 1 to 5 based on the item "
                     f"{{{item_attr}}} and the comment {{{review_attr}}} . "
                     "Output only the digit and nothing else ."),
        mk("summarize", f"Summarize the user's review {{{review_attr}}} on the item "
                        f"{{{item_attr}}} within 20 words ."),
        mk("open", "Who are the most likely audiences for this item given its "
                   f"description {{{item_attr}}} and a sample review {{{review_attr}}} ? "
                   "Explain briefly ."),
    ]
