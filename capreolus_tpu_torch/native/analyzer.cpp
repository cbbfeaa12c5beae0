// Native English analyzer: tokenize + possessive strip + lowercase + stopword
// filter + Porter stemming, matching capreolus_tpu.analysis exactly for ASCII
// text (the Python implementation handles the non-ASCII remainder).
//
// This is the hot host-side path of index building (the reference spends this
// time inside Lucene's Java analyzer; SURVEY.md §3.3 notes per-doc tokenization
// as the main host bottleneck). Built as a shared library and driven via ctypes.

#include <cstring>
#include <cstdlib>
#include <cctype>
#include <string>
#include <vector>

namespace {

// Lucene EnglishAnalyzer.ENGLISH_STOP_WORDS_SET (33 words)
const char* STOPWORDS[] = {
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if", "in",
    "into", "is", "it", "no", "not", "of", "on", "or", "such", "that", "the",
    "their", "then", "there", "these", "they", "this", "to", "was", "will", "with"};

bool is_stopword(const std::string& w) {
    for (const char* s : STOPWORDS)
        if (w == s) return true;
    return false;
}

// ---------------------------------------------------------------- Porter stemmer
// Port of capreolus_tpu/analysis/porter.py (Martin Porter's algorithm with the
// two departures used by Lucene: bli->ble, logi->log).
struct Stem {
    std::string b;
    int k;  // index of last char
    int j;

    explicit Stem(const std::string& w) : b(w), k((int)w.size() - 1), j(0) {}

    bool cons(int i) const {
        char ch = b[i];
        if (ch == 'a' || ch == 'e' || ch == 'i' || ch == 'o' || ch == 'u') return false;
        if (ch == 'y') return i == 0 ? true : !cons(i - 1);
        return true;
    }

    int m() const {
        int n = 0, i = 0;
        while (true) {
            if (i > j) return n;
            if (!cons(i)) break;
            i++;
        }
        i++;
        while (true) {
            while (true) {
                if (i > j) return n;
                if (cons(i)) break;
                i++;
            }
            i++;
            n++;
            while (true) {
                if (i > j) return n;
                if (!cons(i)) break;
                i++;
            }
            i++;
        }
    }

    bool vowel_in_stem() const {
        for (int i = 0; i <= j; i++)
            if (!cons(i)) return true;
        return false;
    }

    bool double_c(int jj) const {
        if (jj < 1) return false;
        if (b[jj] != b[jj - 1]) return false;
        return cons(jj);
    }

    bool cvc(int i) const {
        if (i < 2 || !cons(i) || cons(i - 1) || !cons(i - 2)) return false;
        char ch = b[i];
        return ch != 'w' && ch != 'x' && ch != 'y';
    }

    bool ends(const char* s) {
        int len = (int)strlen(s);
        if (len > k + 1) return false;
        if (b.compare(k - len + 1, len, s) != 0) return false;
        j = k - len;
        return true;
    }

    void setto(const char* s) {
        int len = (int)strlen(s);
        b.replace(j + 1, k - j, s);
        k = j + len;
    }

    void r(const char* s) {
        if (m() > 0) setto(s);
    }
};

void step1ab(Stem& z) {
    if (z.b[z.k] == 's') {
        if (z.ends("sses")) z.k -= 2;
        else if (z.ends("ies")) z.setto("i");
        else if (z.b[z.k - 1] != 's') z.k--;
    }
    if (z.ends("eed")) {
        if (z.m() > 0) z.k--;
    } else if ((z.ends("ed") || z.ends("ing")) && z.vowel_in_stem()) {
        z.k = z.j;
        if (z.ends("at")) z.setto("ate");
        else if (z.ends("bl")) z.setto("ble");
        else if (z.ends("iz")) z.setto("ize");
        else if (z.double_c(z.k)) {
            z.k--;
            char ch = z.b[z.k];
            if (ch == 'l' || ch == 's' || ch == 'z') z.k++;
        } else {
            z.j = z.k;
            if (z.m() == 1 && z.cvc(z.k)) z.setto("e");
        }
    }
}

void step1c(Stem& z) {
    if (z.ends("y") && z.vowel_in_stem()) z.b[z.k] = 'i';
}

void step2(Stem& z) {
    static const char* pairs[][2] = {
        {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"}, {"anci", "ance"},
        {"izer", "ize"}, {"bli", "ble"}, {"alli", "al"}, {"entli", "ent"},
        {"eli", "e"}, {"ousli", "ous"}, {"ization", "ize"}, {"ation", "ate"},
        {"ator", "ate"}, {"alism", "al"}, {"iveness", "ive"}, {"fulness", "ful"},
        {"ousness", "ous"}, {"aliti", "al"}, {"iviti", "ive"}, {"biliti", "ble"},
        {"logi", "log"}};
    for (auto& p : pairs)
        if (z.ends(p[0])) { z.r(p[1]); return; }
}

void step3(Stem& z) {
    static const char* pairs[][2] = {
        {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
        {"ical", "ic"}, {"ful", ""}, {"ness", ""}};
    for (auto& p : pairs)
        if (z.ends(p[0])) { z.r(p[1]); return; }
}

void step4(Stem& z) {
    static const char* suffixes[] = {
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize"};
    for (const char* s : suffixes) {
        if (z.ends(s)) {
            if (strcmp(s, "ion") == 0 && !(z.j >= 0 && (z.b[z.j] == 's' || z.b[z.j] == 't')))
                continue;
            if (z.m() > 1) z.k = z.j;
            return;
        }
    }
}

void step5(Stem& z) {
    z.j = z.k;
    if (z.b[z.k] == 'e') {
        int a = z.m();
        if (a > 1 || (a == 1 && !z.cvc(z.k - 1))) z.k--;
    }
    if (z.b[z.k] == 'l' && z.double_c(z.k) && z.m() > 1) z.k--;
}

std::string porter_stem(const std::string& word) {
    if (word.size() <= 2) return word;
    Stem z(word);
    step1ab(z);
    step1c(z);
    step2(z);
    step3(z);
    step4(z);
    step5(z);
    return z.b.substr(0, z.k + 1);
}

inline bool is_word_char(unsigned char c) {
    // ASCII letters/digits; '_' excluded (matches the Python [^\W_] class)
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || (c >= '0' && c <= '9');
}

inline bool is_mid_char(unsigned char c) {
    return c == '\'' || c == '.' || c == ',' || c == ':';
}

}  // namespace

extern "C" {

// Analyze ASCII text; returns a malloc'd newline-joined token list (caller frees
// with ctpu_free). use_porter/keep_stops mirror the Python analyzer options.
char* ctpu_analyze(const char* text, int use_porter, int keep_stops) {
    std::string out;
    out.reserve(strlen(text));
    size_t n = strlen(text);
    size_t i = 0;
    std::string token;
    while (i < n) {
        unsigned char c = text[i];
        if (!is_word_char(c)) { i++; continue; }
        // token: word chars joined by single mid chars between word chars
        size_t start = i;
        size_t end = i;
        while (end < n) {
            if (is_word_char((unsigned char)text[end])) { end++; continue; }
            if (is_mid_char((unsigned char)text[end]) && end + 1 < n && is_word_char((unsigned char)text[end + 1])) {
                end += 2;
                continue;
            }
            break;
        }
        token.assign(text + start, end - start);
        i = end;
        if (token.size() > 255) continue;  // StandardTokenizer maxTokenLength

        // possessive filter: strip trailing 's / 'S
        if (token.size() >= 2 && (token[token.size() - 1] == 's' || token[token.size() - 1] == 'S') &&
            token[token.size() - 2] == '\'')
            token.resize(token.size() - 2);
        if (token.empty()) continue;
        for (auto& ch : token) ch = (char)tolower((unsigned char)ch);
        if (!keep_stops && is_stopword(token)) continue;
        if (use_porter) token = porter_stem(token);
        out += token;
        out += '\n';
    }
    char* result = (char*)malloc(out.size() + 1);
    memcpy(result, out.c_str(), out.size() + 1);
    return result;
}

void ctpu_free(char* p) { free(p); }

char* ctpu_porter_stem(const char* word) {
    std::string s = porter_stem(word);
    char* result = (char*)malloc(s.size() + 1);
    memcpy(result, s.c_str(), s.size() + 1);
    return result;
}

}  // extern "C"
