// Native TREC-format document reader: the data-loader side of index building.
//
// Parses <DOC>/<DOCNO>/content-tag blocks (the same semantics as
// capreolus_tpu.utils.trec.iterate_trec_docs, itself matching Anserini's
// TrecCollection content tags) in a single pass over a file. Records are
// returned as docid \x1f contents \x1e ... in one malloc'd buffer.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* CONTENT_TAGS[] = {"text", "headline", "title", "hl", "head",
                              "ttl", "dd", "date", "lp", "leadpara"};

bool is_content_tag(const std::string& tag) {
    for (const char* t : CONTENT_TAGS)
        if (tag == t) return true;
    return false;
}

std::string lower(const std::string& s) {
    std::string out = s;
    for (auto& c : out) c = (char)tolower((unsigned char)c);
    return out;
}

std::string strip(const std::string& s) {
    size_t a = s.find_first_not_of(" \t\r\n");
    if (a == std::string::npos) return "";
    size_t b = s.find_last_not_of(" \t\r\n");
    return s.substr(a, b - a + 1);
}

// append text with single-space joining and whitespace collapsing
void append_text(std::string& contents, const std::string& text) {
    std::string t = strip(text);
    if (t.empty()) return;
    std::string collapsed;
    bool prev_space = false;
    for (char c : t) {
        if (isspace((unsigned char)c)) {
            if (!prev_space) collapsed += ' ';
            prev_space = true;
        } else {
            collapsed += c;
            prev_space = false;
        }
    }
    if (!contents.empty()) contents += ' ';
    contents += collapsed;
}

}  // namespace

extern "C" {

// Parse a whole TREC file buffer; returns a malloc'd string of
// docid \x1f contents \x1e records (caller frees with ctpu_free_trec).
char* ctpu_parse_trec(const char* data, long length) {
    std::string out;
    out.reserve(length / 2);

    std::string docid;
    std::string contents;
    std::vector<std::string> tag_stack;
    bool in_doc = false;

    const char* p = data;
    const char* end = data + length;
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl) nl = end;
        std::string line = strip(std::string(p, nl - p));
        p = nl + 1;
        if (line.empty()) continue;
        std::string low = lower(line);

        if (low.rfind("<doc>", 0) == 0) {
            in_doc = true;
            docid.clear();
            contents.clear();
            tag_stack.clear();
        } else if (low.rfind("</doc>", 0) == 0) {
            if (in_doc && !docid.empty()) {
                out += docid;
                out += '\x1f';
                out += contents;
                out += '\x1e';
            }
            in_doc = false;
        } else if (!in_doc) {
            continue;
        } else if (low.rfind("<docno>", 0) == 0) {
            std::string rest = line.substr(7);
            size_t close = lower(rest).find("</docno>");
            if (close != std::string::npos) rest = rest.substr(0, close);
            docid = strip(rest);
        } else if (low.rfind("</", 0) == 0) {
            size_t gt = low.find('>');
            std::string tag = low.substr(2, gt == std::string::npos ? std::string::npos : gt - 2);
            if (!tag_stack.empty() && tag_stack.back() == tag) tag_stack.pop_back();
        } else if (low[0] == '<') {
            size_t gt = low.find('>');
            std::string tag = low.substr(1, gt == std::string::npos ? std::string::npos : gt - 1);
            if (tag == "p" || tag == "br") continue;  // markup inside content blocks
            tag_stack.push_back(tag);
            // inline content on the same line: <TAG> text [</TAG>]
            if (gt != std::string::npos && gt + 1 < line.size() && is_content_tag(tag)) {
                std::string text = line.substr(gt + 1);
                std::string closing = "</" + tag + ">";
                size_t close = lower(text).find(closing);
                if (close != std::string::npos) {
                    text = text.substr(0, close);
                    tag_stack.pop_back();
                }
                append_text(contents, text);
            }
        } else {
            bool inside_content = false;
            for (const auto& t : tag_stack)
                if (is_content_tag(t)) { inside_content = true; break; }
            if (inside_content) append_text(contents, line);
        }
    }
    char* result = (char*)malloc(out.size() + 1);
    memcpy(result, out.c_str(), out.size() + 1);
    return result;
}

void ctpu_free_trec(char* p) { free(p); }

}  // extern "C"
