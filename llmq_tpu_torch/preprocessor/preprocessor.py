"""Message preprocessor: content analysis → priority assignment (the
port's copy of ``llmq_tpu/preprocessor/preprocessor.py``).

Priority inference order:

1. an explicit non-default priority is respected
2. ``metadata["user_priority"]``
3. the per-user default set through ``set_user_priority``
4. admin content rules (most urgent match wins)
5. keyword scoring: realtime = {immediate, emergency, asap, right now},
   high = {urgent, important, priority, critical, soon}; case
   insensitive, the tier with the most hits wins

Content annotation: word and character counts, a lexicon sentiment,
question detection and the ``analyzed`` marker.
"""

from __future__ import annotations

import logging
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from llmq_tpu_torch.core.types import Message, Priority

log = logging.getLogger("llmq_tpu_torch.preprocessor")

# Keyword tiers.
REALTIME_KEYWORDS = ("immediate", "emergency", "asap", "right now")
HIGH_KEYWORDS = ("urgent", "important", "priority", "critical", "soon")

_POSITIVE_WORDS = frozenset(
    "good great excellent amazing wonderful fantastic love happy thanks "
    "thank perfect best awesome nice helpful".split())
_NEGATIVE_WORDS = frozenset(
    "bad terrible awful horrible hate angry wrong broken fail failed "
    "error problem worst useless annoying".split())

_QUESTION_WORDS = ("what", "why", "how", "when", "where", "who", "which",
                   "can", "could", "would", "should", "is", "are", "do",
                   "does", "did")


def _compile(words: Tuple[str, ...]) -> List[re.Pattern]:
    return [re.compile(r"\b" + re.escape(w).replace(r"\ ", r"\s+") + r"\b",
                       re.IGNORECASE) for w in words]


_REALTIME_PATTERNS = _compile(REALTIME_KEYWORDS)
_HIGH_PATTERNS = _compile(HIGH_KEYWORDS)


@dataclass
class PriorityRule:
    """An admin-registered content rule: messages whose content matches
    ``pattern`` get ``priority``."""

    name: str
    pattern: str
    priority: Priority
    compiled: re.Pattern = field(repr=False, default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self.priority = Priority.parse(self.priority)
        self.compiled = re.compile(self.pattern, re.IGNORECASE)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "pattern": self.pattern,
                "priority": self.priority.tier_name}


class Preprocessor:
    def __init__(self, enable_content_analysis: bool = True) -> None:
        self.enable_content_analysis = enable_content_analysis
        self._user_priorities: Dict[str, Priority] = {}
        self._rules: List[PriorityRule] = []
        self._mu = threading.RLock()

    # -- admin rules ---------------------------------------------------------

    def add_rule(self, pattern: str, priority: Priority,
                 name: str = "") -> PriorityRule:
        rule = PriorityRule(name=name or f"rule-{pattern[:24]}",
                            pattern=pattern, priority=priority)
        with self._mu:
            self._rules.append(rule)
        return rule

    def list_rules(self) -> List[PriorityRule]:
        with self._mu:
            return list(self._rules)

    def remove_rule(self, name: str) -> bool:
        with self._mu:
            n = len(self._rules)
            self._rules = [r for r in self._rules if r.name != name]
            return len(self._rules) != n

    # -- user defaults -------------------------------------------------------

    def set_user_priority(self, user_id: str, priority: Priority) -> None:
        with self._mu:
            self._user_priorities[user_id] = Priority.parse(priority)

    def remove_user_priority(self, user_id: str) -> bool:
        with self._mu:
            return self._user_priorities.pop(user_id, None) is not None

    def get_user_priorities(self) -> Dict[str, Priority]:
        with self._mu:
            return dict(self._user_priorities)

    # -- main pipeline -------------------------------------------------------

    def process_message(self, message: Message) -> Message:
        message.priority = self._infer_priority(message)
        if self.enable_content_analysis:
            self._annotate(message)
        message.metadata["analyzed"] = True
        return message

    def _infer_priority(self, message: Message) -> Priority:
        # 1. an explicit non-default priority wins
        if message.priority != Priority.NORMAL:
            return message.priority
        # 2. metadata override
        override = message.metadata.get("user_priority")
        if override is not None:
            try:
                return Priority.parse(override)
            except (ValueError, TypeError):
                log.warning("invalid user_priority metadata %r on message %s",
                            override, message.id)
        # 3. per-user default
        with self._mu:
            user_default = self._user_priorities.get(message.user_id)
        if user_default is not None:
            return user_default
        # 4. admin content rules (most urgent match wins) — slotted above
        # keyword scoring so operators can override the built-in lexicon.
        with self._mu:
            rules = list(self._rules)
        hits = [r.priority for r in rules if r.compiled.search(message.content)]
        if hits:
            return min(hits)
        # 5. keyword scoring
        return self._analyze_priority(message.content)

    @staticmethod
    def _analyze_priority(content: str) -> Priority:
        rt_hits = sum(1 for p in _REALTIME_PATTERNS if p.search(content))
        hi_hits = sum(1 for p in _HIGH_PATTERNS if p.search(content))
        if rt_hits == 0 and hi_hits == 0:
            return Priority.NORMAL
        return Priority.REALTIME if rt_hits >= hi_hits else Priority.HIGH

    # -- content annotation --------------------------------------------------

    def _annotate(self, message: Message) -> None:
        message.metadata.update(analyze_text(message.content))


def analyze_text(content: str) -> Dict[str, Any]:
    words = re.findall(r"[\w']+", content.lower())
    pos = sum(1 for w in words if w in _POSITIVE_WORDS)
    neg = sum(1 for w in words if w in _NEGATIVE_WORDS)
    sentiment = "neutral"
    if pos > neg:
        sentiment = "positive"
    elif neg > pos:
        sentiment = "negative"
    stripped = content.strip()
    is_question = stripped.endswith("?") or (
        bool(words) and words[0] in _QUESTION_WORDS)
    return {
        "word_count": len(words),
        "char_count": len(content),
        "sentiment": sentiment,
        "is_question": is_question,
    }


def analyze_message_content(message: Message) -> Dict[str, Any]:
    """Standalone analysis: the analysis dict, without mutating the
    message."""
    analysis = analyze_text(message.content)
    analysis["suggested_priority"] = int(
        Preprocessor._analyze_priority(message.content))
    return analysis
